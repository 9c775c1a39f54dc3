"""Parallel tempering of the port: the label-swap exchange (``pt``), its
driver (``pt_driver``) and the det-coupled config-swap driver
(``det_pt``)."""
