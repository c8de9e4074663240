"""One module an architecture, ``bench/arch/<model_type>.py``, found by the
``model_type`` key of a configuration file (:func:`bench.models.arch`).

Each module gives ``program_config(cfg)``, the port's ``ModelConfig`` of
the configuration as run (importing the program inside the function only);
``is_norm_leaf(path, shape)``, whether a weight leaf of the port's tree is a
norm weight; and ``Model``, the float32 reference class, from a module of
``bench/reference/`` that imports nothing of the program.  A module whose
name begins with ``_`` is code that architectures share.
"""
