"""Data: XCT phantoms and measurement simulation (``phantom``), and the
LM training slice's synthetic token stream (``tokens``)."""
