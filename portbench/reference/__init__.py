"""The plain reference: the configuration's model and trainer in float32
PyTorch, written from the configuration file's ``as_run`` numbers. It
imports nothing of the port (``repro_torch``), no kernel, and takes only
the weights tree and the tokens the benchmark made."""
