"""The designs of the row-major kernels K10 (csrc/pixel_loss.cu,
pixel_ce_rows_bwd_kernel) and K7 (csrc/segment.cu, ssm_rows_span_kernel),
stated in numpy and held on the CPU against the port's plain versions:

- K10: tiles of R rows (PIXELS_PER_BLOCK, and 128 for more tiles). A
  tile's units (float4s where C % 4 == 0, else floats) go to row
  j // W (W units a row); only the units of live rows (a candidate among
  the low C bits) are read, into a tile whose rows lie W | 1 units apart;
  each row's dl is K2's arithmetic (tests/test_torch_port_pixel_kernels.py
  _k2) on the row as the tile holds it, zeros for a dead row, and the
  tile is stored back unit by unit. The statement equals _k2 on the same
  rows bitwise (the tile moves values, it computes nothing) and
  pixel_ce_bwd_plain on the rows' (1, C, N) view within 1e-6 of max |dl|,
  as chip_smoke.py holds the kernel, on C in {7, 8, 20}, full and short
  last tiles (N % R != 0, N % 4 != 0), all-dead and all-live rows. The
  odd stride keeps the threads' accesses to their own rows on distinct
  banks.
- K7: spans of SPAN rows, each cut into 8 contiguous warp shares, the
  warps taken in a random order; a warp queues the valid rows of its
  share in raster order and takes up to 32 of them a step (each lane
  reading only its own row), runs are formed over the queued rows (an
  invalid row does not end a run), a run's first lane claims slot
  id % NSLOT (claims of one step in a random order), the run's max key
  (value bits << 32 | ~row) goes to its slot if its id holds it, else
  straight to the global table, and each claimed slot is flushed after
  the span. On probabilities in the kernel's own arithmetic (bf16 rows,
  exp, the sum in class order, e / z: _class_order_softmax, a helper of
  these tests) it equals segment_max_plain bitwise, and it is held
  against ssm_rows_fwd_plain as chip_smoke.py holds the kernel (absent
  sets exact, maxima within 1e-6, argmax rows at the plain maximum within
  1e-6), with small spans and few slots so that slots collide and
  overflow, exact ties across warp, step and span borders, long invalid
  runs, runs that start mid-warp and an underflowed class.
- The wrappers' choices: each kernel's instance (C = 20 compiled or C at
  run time; 16-byte units or 4-byte ones on an offset view or where
  C % 4 != 0) reaches the library, and K7's span and slot count reach the
  build as -D flags and key its cache.
"""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.ops import _build, pixel_loss, segment
from tests import test_torch_port_pixel_kernels as pk

torch.set_num_threads(1)

TEMP = pk.TEMP  # 0.1, the temperature of pk._k2


# ---------------------------------------------------------------- K10 ---

def _k10_rows(C, N, kind, seed=0):
    """Logits 3 N(0, 1) as (N, C) rows and bitmasks (dead, one-hot or
    multi-hot in runs of 6 rows; or every row dead or live), via pk._case
    on one image."""
    x, bits = pk._case(C, N, kind, B=1, seed=seed)
    return np.ascontiguousarray(x[0].T), bits[0, 0]


def _k10_tile(x, bits, g, R, wide):
    """K10 in numpy: (N, C) rows -> (dl (N, C), which logits were read)."""
    N, C = x.shape
    F = 4 if wide else 1
    W = C // F
    ws = W | 1
    mask = (1 << C) - 1
    src = x.reshape(-1, F)  # the rows as units
    dl = np.full_like(src, np.nan)
    read = np.zeros(src.shape[0], bool)
    for r0 in range(0, N, R):
        rows = min(R, N - r0)
        sb = np.zeros(R, np.int64)
        sb[:rows] = bits[r0:r0 + rows]
        tile = np.full((R * ws, F), np.nan, np.float32)
        j = np.arange(rows * W)
        r, col = j // W, j % W
        live = (sb[r] & mask) != 0
        u0 = r0 * W  # the tile's first unit
        tile[r[live] * ws + col[live]] = src[u0 + j[live]]
        read[u0 + j[live]] = True
        # one thread per row: the row as the tile holds it, K2's dl
        at = np.arange(rows)[:, None] * ws + np.arange(W)
        held = tile[at].reshape(rows, C)
        with np.errstate(invalid="ignore"):
            d = pk._k2(held.T[None], sb[None, None, :rows].astype(np.int32),
                       g)[0].T
        tile[at] = d.reshape(rows, W, F)
        dl[u0 + j] = tile[r * ws + col]
    return dl.reshape(N, C), read.repeat(F).reshape(N, C)


K10_CASES = [(C, N, wide) for C in (7, 8, 20)
             for N in (3 * pixel_loss.PIXELS_PER_BLOCK,
                       2 * pixel_loss.PIXELS_PER_BLOCK + 37)
             for wide in (False, True) if C % 4 == 0 or not wide]


@pytest.mark.parametrize("R", [pixel_loss.PIXELS_PER_BLOCK, 128])
@pytest.mark.parametrize("kind", ["runs", "dead", "live"])
@pytest.mark.parametrize("C,N,wide", K10_CASES)
def test_k10_tile_matches_plain(C, N, wide, kind, R):
    x, bits = _k10_rows(C, N, kind)
    g = np.array([2.0, 3.0], np.float32)
    got, read = _k10_tile(x, bits, g, R, wide)
    live = (bits & ((1 << C) - 1)) != 0
    # every element written; only live rows' logits read; dead rows zero
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(read, np.broadcast_to(live[:, None],
                                                        got.shape))
    assert (got[~live] == 0).all()
    assert live.all() if kind == "live" else not live.all()
    # the tile moves K2's numbers unchanged
    want_k2 = pk._k2(x.T[None].copy(), bits[None, None], g)[0].T
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want_k2.view(np.uint32))
    want = pixel_loss.pixel_ce_bwd_plain(
        torch.from_numpy(x.T.copy())[None],
        torch.from_numpy(bits)[None, None], torch.from_numpy(g),
        TEMP)[0].t().numpy()
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(),
                                                  1e-30)
    assert (np.abs(want).max() > 0) == (kind != "dead")


def test_k10_units_belong_to_rows():
    """At C = 20 a float4 lies inside one row: unit j is floats 4j..4j+3,
    all of row j // 5, and the tile's rows are packed (stride 5)."""
    C, W = 20, 5
    j = np.arange(4 * 512 * W)
    rows_of_floats = (4 * j[:, None] + np.arange(4)) // C
    np.testing.assert_array_equal(rows_of_floats, np.repeat(
        (j // W)[:, None], 4, axis=1))
    assert (W | 1) == W


@pytest.mark.parametrize("wide", [False, True])
def test_tile_stride_is_free_of_bank_conflicts(wide):
    """W | 1 units from row to row: a warp's 4-byte accesses to its 32
    rows' word c, or a quarter-warp's 16-byte accesses to its 8 rows'
    unit i, hit distinct banks of 4 bytes, for every C the kernels take."""
    for C in range(1, 33):
        if wide and C % 4:
            continue
        F = 4 if wide else 1
        ws = (C // F) | 1
        lanes = 8 if wide else 32
        for i in range(C // F):
            words = (np.arange(lanes)[:, None] * ws + i) * F + np.arange(F)
            banks = words.reshape(-1) % 32
            assert len(set(banks)) == banks.size, (C, wide, i)


# ----------------------------------------------------------------- K7 ---

def _key_bits(p):
    return np.asarray(p, np.float32).view(np.uint32).astype(np.uint64)


def _class_order_softmax(x):
    """The softmax in K7's order: the float32 softmax of the bf16-rounded
    rows, exp(u - max) summed in class order, then e / z. The plain
    version (segment.ssm_rows_fwd_plain) sums with torch's sum; this
    order is what lets the walk be held bitwise."""
    u = segment._round_bf16(torch.from_numpy(x))
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    z = e[:, 0]
    for c in range(1, e.shape[1]):
        z = z + e[:, c]
    return (e / z[:, None]).numpy()


def _k7_walk(x, sid, S, span, nslot, rng):
    """K7's span walk in numpy over (P, C) rows: ((S, C) float32 max,
    (S, C) int64 first-argmax row, rows read, steps, runs sent to the
    global table past a held slot)."""
    P, C = x.shape
    probs = _class_order_softmax(x)
    kbits = _key_bits(probs)
    valid = (sid >= 0) & (sid < S)
    table = np.zeros((S, C), np.uint64)
    n_read = n_steps = n_overflow = 0
    share = span // 8
    for start in range(0, P, span):
        tags, slots = {}, np.zeros((nslot, C), np.uint64)
        for w in rng.permutation(8):
            lo, hi = min(start + w * share, P), min(start + (w + 1) * share, P)
            queue = lo + np.flatnonzero(valid[lo:hi])
            for q0 in range(0, queue.size, 32):
                rows = queue[q0:q0 + 32]  # a step: each lane its own row
                n_read += rows.size
                n_steps += 1
                ids = sid[rows]
                heads = np.flatnonzero(np.diff(ids, prepend=-1) != 0)
                runs = np.split(np.arange(rows.size), heads[1:])
                held = {}
                for k in rng.permutation(len(runs)):
                    sk = int(ids[runs[k][0]])
                    held[k] = tags.setdefault(sk % nslot, sk) == sk
                for k, m in enumerate(runs):
                    sk = int(ids[m[0]])
                    key = ((kbits[rows[m]] << np.uint64(32))
                           | (~rows[m].astype(np.uint32)).astype(
                               np.uint64)[:, None]).max(axis=0)
                    if held[k]:
                        slots[sk % nslot] = np.maximum(slots[sk % nslot], key)
                    else:
                        table[sk] = np.maximum(table[sk], key)
                        n_overflow += 1
        for slot, sk in tags.items():
            table[sk] = np.maximum(table[sk], slots[slot])
    vals = (table >> np.uint64(32)).astype(np.uint32).view(np.float32)
    pix = np.where(table == 0, P,
                   ~(table & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return vals, pix.astype(np.int64), n_read, n_steps, n_overflow


def _k7_case(kind, C, span=256):
    """(rows divided by T = 0.1, sid, S):
    runs7      runs of 7 rows over 23 ids (runs start mid-warp), 5%
               invalid, id 3 absent, exact ties between rows 2k+1 and
               2k+2 (so across warp and span borders);
    underflow  the same with class 0 underflowing to probability 0.0;
    invalid    runs7 without ties, rows 20-109 and 150-599 invalid;
    collide    runs of 4 whose ids are equal modulo 4 in groups of 8;
    border     runs7, plus one id around each span border whose class-0
               maximum is tied between the last row of a span and the
               first of the next."""
    rng = np.random.RandomState(C + len(kind))
    P = 5 * span + 45
    x = rng.randn(P, C).astype(np.float32)
    S = 23
    sid = np.repeat(rng.randint(0, S, -(-P // 7)), 7)[:P]
    if kind == "invalid":
        sid[20:110] = S
        sid[150:600] = S
    elif kind == "collide":
        r = np.arange(-(-P // 4))
        sid = np.repeat((r * 4 + r // 8) % S, 4)[:P]
    else:
        sid[rng.rand(P) < 0.05] = S
        x[2::2] = x[1:-1:2]
    if kind == "underflow":
        x[:, 0] -= 40.0
    sid[sid == 3] = S  # absent
    if kind == "border":
        for b in range(span, P, span):
            sid[b - 5:b + 5] = 3
            x[b - 5:b + 5, 0] = -10.0
            x[b - 1, 0] = 5.0
            x[b] = x[b - 1]
    return (x * 10).astype(np.float32), sid.astype(np.int32), S


K7_KINDS = ["runs7", "underflow", "invalid", "collide", "border"]


@pytest.mark.parametrize("span,nslot", [(256, 4), (512, 4), (256, 8),
                                        (2048, 16)])
@pytest.mark.parametrize("C", [20, 7])
@pytest.mark.parametrize("kind", K7_KINDS)
def test_k7_span_walk_equals_plain(kind, C, span, nslot):
    x, sid, S = _k7_case(kind, C)
    got_v, got_p, n_read, n_steps, _ = _k7_walk(
        x, sid, S, span, nslot, np.random.RandomState(span + nslot))
    want_v, want_p = segment.segment_max_plain(
        torch.from_numpy(_class_order_softmax(x)), torch.from_numpy(sid), S)
    np.testing.assert_array_equal(got_p, want_p.numpy())
    np.testing.assert_array_equal(got_v.view(np.uint32),
                                  want_v.numpy().view(np.uint32))
    # against the plain version, as chip_smoke.py holds the kernel
    plain_v, plain_p = (t.numpy() for t in segment.ssm_rows_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(sid), S))
    P = x.shape[0]
    absent = got_p == P
    np.testing.assert_array_equal(absent, plain_p == P)
    assert (got_v[absent] == 0).all()
    assert np.abs(got_v - plain_v).max() <= 1e-6
    plain_probs = torch.softmax(segment._round_bf16(torch.from_numpy(x)),
                                dim=1).numpy()
    cls = np.broadcast_to(np.arange(C), (S, C))[~absent]
    assert np.abs(plain_probs[got_p[~absent], cls]
                  - plain_v[~absent]).max() <= 1e-6
    # only valid rows are read, 32 a step but where a share runs out
    n_valid = int((sid < S).sum())
    assert n_read == n_valid and n_steps < n_valid / 32 + 8 * -(-len(sid)
                                                                // span)
    assert (got_p < P).any()
    if kind == "border":  # each border's tie goes to the earlier row
        assert got_p[3, 0] == 256 - 1
    else:  # id 3 is absent
        assert (got_p[3] == P).all()
    if kind == "underflow":
        assert (got_v[got_p[:, 0] < P, 0] == 0).all()


def test_k7_fixtures_reach_the_traps():
    """Slots overflow in the collide case; the runs7 case has runs that
    start mid-warp and ties across warp borders; the invalid case has
    invalid runs longer than a warp share."""
    x, sid, S = _k7_case("collide", 20)
    *_, n_over = _k7_walk(x, sid, S, 256, 4, np.random.RandomState(0))
    assert n_over > 0
    x, sid, S = _k7_case("runs7", 20)
    heads = np.flatnonzero(np.diff(sid, prepend=-1) != 0)
    assert (heads % 32 != 0).any()
    assert (x[31] == x[32]).all() and (x[63] == x[64]).all()
    _, sid, S = _k7_case("invalid", 20)
    inv = np.concatenate([[0], (sid == S).astype(np.int8), [0]])
    edges = np.flatnonzero(np.diff(inv))
    assert (edges[1::2] - edges[0::2]).max() >= 2 * 256 // 8


def test_k7_arithmetic_in_numpy():
    """_class_order_softmax states the kernel's order: bf16 rows, exp(u -
    max), the sum in class order, e / z; numpy's float32 exp in that order
    agrees within 2 float32 ulps."""
    x, _, _ = _k7_case("runs7", 20)
    u = pk_bf16(x)
    e = np.exp(u - u.max(axis=1, keepdims=True)).astype(np.float32)
    z = e[:, 0].copy()
    for c in range(1, 20):
        z = z + e[:, c]
    p = e / z[:, None]
    got = _class_order_softmax(x)
    assert np.abs(p - got).max() <= 2 * 2.0 ** -23


def pk_bf16(a):
    """round to nearest even bf16, kept in float32 (the kernels' trick)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# --------------------------------------------------- instances, flags ---

@pytest.mark.parametrize("C,offset,bits_offset,want", [
    (20, 0, 0, (20, True)), (20, 1, 0, (20, False)), (20, 4, 0, (20, True)),
    (20, 0, 1, (20, False)), (8, 0, 0, (0, True)), (8, 2, 0, (0, False)),
    (7, 0, 0, (0, False)), (31, 0, 0, (0, False))])
def test_rows_instances(C, offset, bits_offset, want):
    """16-byte units need C % 4 == 0 and 16-byte aligned rows (and, for
    K10, bitmasks); C = 20 is compiled, any other C runs at run time."""
    N = 64
    x = torch.zeros(N * C + offset)[offset:].view(N, C)
    bits = torch.zeros(N + bits_offset, dtype=torch.int32)[bits_offset:]
    assert pixel_loss.rows_instance(x, bits) == want
    if not bits_offset:
        assert segment.rows_instance(x) == want


@pytest.mark.parametrize("want", [(20, True), (20, False), (0, True),
                                  (0, False)])
def test_wrappers_pass_the_instance(monkeypatch, want):
    """K7's and K10's wrappers hand their instance to the library and count
    one launch each."""
    lib = pk._FakeLib()
    monkeypatch.setattr(segment, "_lib", lambda: lib)
    monkeypatch.setattr(pixel_loss, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(segment, "rows_instance", lambda x: want)
    monkeypatch.setattr(pixel_loss, "rows_instance", lambda x, b: want)
    C = 20 if want[0] else 8
    x = torch.empty(100, C, device="meta")
    ids = torch.empty(100, dtype=torch.int32, device="meta")
    segment.ssm_rows_fwd(x, ids, 5)
    pixel_loss.pixel_ce_rows_bwd(x, ids, torch.empty(2, device="meta"), TEMP)
    assert [c[0] for c in lib.calls] == ["ssm_rows_fwd", "pixel_ce_rows_bwd"]
    for _, args in lib.calls:
        assert args[-3:-1] == (want[0], int(want[1]))
    assert dict(_build.LAUNCHES) == {"ssm_rows_fwd": 1,
                                     "pixel_ce_rows_bwd": 1}


def test_k7_span_and_slot_counts_reach_the_build(monkeypatch):
    """segment.cu is built with K7_SPAN and K7_SLOTS as -DROWS_SPAN and
    -DROWS_NSLOT (before K3's two), and its cached library is keyed on
    them."""
    span, nslot = segment.K7_SPAN, segment.K7_SLOTS
    flags = _build.flags("segment")
    assert flags[-4:-2] == (f"-DROWS_SPAN={span}", f"-DROWS_NSLOT={nslot}")
    # 8 warp shares of whole 32-row chunks; slot = id & (NSLOT - 1)
    assert span % 256 == 0 and nslot & (nslot - 1) == 0 and nslot >= 4
    built = _build._target("segment")
    for key, value in (("ROWS_SPAN", 2 * span), ("ROWS_NSLOT", 2 * nslot)):
        monkeypatch.setitem(_build.DEFINES, "segment",
                            dict(_build.DEFINES["segment"], **{key: value}))
        assert _build._target("segment") != built


def test_shared_header_keys_every_build(monkeypatch, tmp_path):
    """The sources that include csrc/common.cuh are rebuilt when it
    changes: every library's cache key covers the shared headers."""
    names = ["segment", "pixel_loss", "prereduce", "segment_max"]
    for p in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    built = {name: _build._target(name) for name in names}
    for name in ("segment", "pixel_loss", "prereduce"):
        assert '#include "common.cuh"' in (tmp_path / f"{name}.cu").read_text()
    (tmp_path / "common.cuh").write_text(
        (tmp_path / "common.cuh").read_text() + "\n// changed\n")
    for name in names:
        assert _build._target(name) != built[name]
