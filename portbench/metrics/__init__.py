"""One reader a per-layer metric. The harness takes ``<metric>.py`` where
there is one, else the file of the metric's base name (its name up to the
first dot), which its variants share: ``mfu.py`` reads ``mfu.train``,
``mfu.small_batch`` and ``mfu.prefill``. ``read(ctx)`` returns the
metric's value, or None where its run holds nothing to read; ``ctx`` has
``trace`` (a ``portbench.trace.Trace`` of the profiled stretch), ``spec``
(the model as run), ``mix`` and ``window`` (the measured window's
``seconds`` and its ``units``, one ``{"batch", "seq"}`` a step or
batch)."""
