"""Developer tooling: the steady-state guard (``jitcheck``), the opt-in
runtime lock-order and leak validators (``lockcheck``, ``leakcheck``) and
the postmortem reader of the flight-recorder rings (``postmortem``).

Nothing in this package is imported by the runtime unless explicitly
enabled (the ``*_check_enabled`` config knobs) — shipping code pays zero
cost for it.
"""
