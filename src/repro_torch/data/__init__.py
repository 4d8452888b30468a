"""XCT phantoms and measurement simulation."""
