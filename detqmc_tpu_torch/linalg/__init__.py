"""Linear algebra of the port: B-chain applies, UdV stabilization and the
three kernel modules (slice_update, qr, green_solve)."""
