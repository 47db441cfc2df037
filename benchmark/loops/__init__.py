"""One loop a traffic kind: train, plbl."""
