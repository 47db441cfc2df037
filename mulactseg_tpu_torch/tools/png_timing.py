"""Times the standard-library PNG readers (utils/png.py read_rgb8 and
read_gray8) on the host, on 1024x2048 files written with each PNG row
filter, the way the stage-2 loader meets them.

    python3 mulactseg_tpu_torch/tools/png_timing.py [--root DIR] \
        [--repeats 5] [--threads 4] [--out FILE]

The image is photo-like and made from a seed: a 33x65 random field
interpolated to 1024x2048, plus N(0, 4) noise, as uint8 RGB; the
greyscale file is its first channel. Each file kind is encoded here:
"filter0" by the port's own writer (every row filter 0, the files the
stage-2 phase of chip_smoke.py reads), "adaptive" with libpng's
heuristic (per row, the filter whose bytes, taken as signed, have the
least sum of magnitudes: a mix of Sub, Up and Paeth rows on such an
image), and "sub", "up", "average", "paeth" with that one filter on
every row. For each kind it prints the filters used, the decode checked
against the image, the median of --repeats single-threaded reads (ms),
and the files per second of --threads threads reading 2 x --threads
files at once (a loader's thread pool), and of as many spawned processes (started and warmed before
the clock). Beside them, the median time of zlib's inflate of the file's
IDAT alone, which any decoder pays. --root times the readers of another checkout
(its mulactseg_tpu_torch/), so two versions compare on one host. Prints
the host's CPU model, then one JSON line; --out writes the line to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

H, W = 1024, 2048


def photo(seed: int = 0) -> np.ndarray:
    """(H, W, 3) uint8: a smooth random field plus noise."""
    rng = np.random.RandomState(seed)
    base = rng.rand(33, 65, 3) * 255
    ys, xs = np.linspace(0, 32, H), np.linspace(0, 64, W)
    y0, x0 = np.minimum(ys.astype(int), 31), np.minimum(xs.astype(int), 63)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    rows = base[y0] * (1 - wy) + base[y0 + 1] * wy
    img = rows[:, x0] * (1 - wx) + rows[:, x0 + 1] * wx
    img += rng.randn(H, W, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(path: str, img: np.ndarray, mode: str) -> list:
    """Writes img with the row filters `mode` asks for (one filter name,
    or "adaptive"); returns the filter of each row."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch).astype(np.int64)
    a = np.concatenate([np.zeros((h, ch), np.int64), x[:, :-ch]], 1)
    b = np.concatenate([np.zeros((1, w * ch), np.int64), x[:-1]], 0)
    c = np.concatenate([np.zeros((h, ch), np.int64), b[:, :-ch]], 1)
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = np.stack([x, x - a, x - b, x - (a + b) // 2,
                         x - paeth]) % 256  # (5, h, w * ch)
    names = ["none", "sub", "up", "average", "paeth"]
    if mode == "adaptive":
        signed = np.where(filtered > 127, 256 - filtered, filtered)
        ftype = signed.sum(-1).argmin(0)
    else:
        ftype = np.full(h, names.index(mode))
    rows = np.concatenate([ftype[:, None], filtered[ftype, np.arange(h)]],
                          1).astype(np.uint8)
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, 0 if ch == 1 else 2,
                                                      0, 0, 0])

    def chunk(kind, data):
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
        return (len(data).to_bytes(4, "big") + kind + data
                + crc.to_bytes(4, "big"))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
    return ftype.tolist()


def read_file(root: str, path: str, gray: bool) -> None:
    """One read with the readers of the checkout at `root` (for the
    worker processes, which start from a fresh import)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    from mulactseg_tpu_torch.utils import png

    (png.read_gray8 if gray else png.read_rgb8)(path)


def files_per_s(pool, root: str, path: str, gray: bool, n: int) -> float:
    t0 = time.perf_counter()
    list(pool.map(read_file, [root] * n, [path] * n, [gray] * n))
    return n / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    from mulactseg_tpu_torch.utils import png

    cpu = platform.processor() or platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), cpu)
    print(f"host: {cpu}, {os.cpu_count()} cores", flush=True)
    rgb = photo()
    kinds = [("filter0", rgb, None), ("adaptive", rgb, "adaptive"),
             ("sub", rgb, "sub"), ("up", rgb, "up"),
             ("average", rgb, "average"), ("paeth", rgb, "paeth"),
             ("filter0_gray", rgb[..., 0], None),
             ("adaptive_gray", rgb[..., 0], "adaptive")]
    root = str(Path(args.root).resolve())
    out = {"root": root, "host": cpu, "shape": [H, W],
           "threads": args.threads, "files": {}}
    n = 2 * args.threads
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(args.threads) as threads, \
            ProcessPoolExecutor(args.threads,
                                mp_context=get_context("spawn")) as procs:
        warm = os.path.join(tmp, "warm.png")
        png.write_gray8(warm, np.zeros((1, 1), np.uint8))
        files_per_s(procs, root, warm, True, n)  # start the workers
        for name, img, mode in kinds:
            path = os.path.join(tmp, f"{name}.png")
            gray = img.ndim == 2
            if mode is None:
                (png.write_gray8 if gray else png.write_rgb8)(path, img)
                ftype = [0] * H
            else:
                ftype = encode(path, img, mode)
            read = png.read_gray8 if gray else png.read_rgb8
            ok = bool(np.array_equal(read(path), img))
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                read(path)
                times.append(time.perf_counter() - t0)
            rate = files_per_s(threads, root, path, gray, n)
            proc_rate = files_per_s(procs, root, path, gray, n)
            with open(path, "rb") as f:
                # signature, IHDR, IDAT header; IDAT CRC, IEND
                idat = f.read()[8 + 25 + 8:-(4 + 12)]
            inflate = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                zlib.decompress(idat)
                inflate.append(time.perf_counter() - t0)
            out["files"][name] = {
                "filters": {str(k): ftype.count(k) for k in sorted(
                    set(ftype))}, "bytes": os.path.getsize(path),
                "decoded_equal": ok, "read_ms": statistics.median(times) * 1e3,
                "read_ms_all": [t * 1e3 for t in times],
                "files_per_s_threads": rate,
                "files_per_s_processes": proc_rate,
                "inflate_ms": statistics.median(inflate) * 1e3}
            print(f"{name}: {out['files'][name]['read_ms']:.1f} ms, "
                  f"{rate:.2f} files/s on {args.threads} threads, "
                  f"{proc_rate:.2f} on as many processes, equal {ok}",
                  flush=True)
    line = json.dumps({"png_timing": out})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not all(v["decoded_equal"] for v in out["files"].values()):
        sys.exit("a PNG reader decoded a file wrongly")


if __name__ == "__main__":
    main()
