"""e2m1 / e8m0 codecs."""
