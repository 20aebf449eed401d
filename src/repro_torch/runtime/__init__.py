"""Runtime support: fault injection, health and straggler signals, and
preemption (``fault_tolerance``)."""
