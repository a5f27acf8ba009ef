"""Camera geometry, vector math and image helpers."""
