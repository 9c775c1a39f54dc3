"""Linear algebra of the port: B-chain applies, UdV stabilization and the
kernel modules (slice_update, sdw_update, sdw_delayed, sdw_wrap, qr,
green_solve, trinv), each a kernel wrapper beside its plain version."""
