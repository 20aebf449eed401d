"""Runtime support: fault injection, health and straggler signals, and
preemption (``fault_tolerance``); the tile tuner (``autotune``) and the
interleaved timing it measures with (``timing``)."""
