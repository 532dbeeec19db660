"""One module per kind of window, found by the traffic mix's ``job``.
A job module has ``Job(ctx)`` with ``setup()``, ``window(seconds)``,
``end_to_end(win)``, ``layers()``, ``trace_info(win)``, ``release()``
and ``check()``; ``calibrate.py`` also calls its ``readings`` and
``control_readings``."""
