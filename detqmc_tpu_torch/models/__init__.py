"""Models of the port (Hubbard; the SDW model is a later slice)."""
