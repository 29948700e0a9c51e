"""Iteration entries, one module a kind of configuration, named by a
configuration file's ``entry``: ``setup(config, traffic, seed, device)``
returns a cell with ``prepare_s``, ``info``, ``step()``, ``release()`` and
``check(outputs)``."""
