"""Runtime support: deterministic fault injection (``fault_tolerance``)."""
