"""The benchmark of the PyTorch/CUDA port (``modular_audio_pipeline_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``control.py`` reads the
numbers the limits in ``limits/`` are set from. A configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json`` (its
parameters, run by the module of the ``kind`` it names,
``kinds/<kind>.py``, with its generator: the two kinds here share
``synth.py``), a per-layer metric ``metrics/<name>.py`` and a cell's
limits ``limits/<workload>.json``; the plain reference is
``reference/``; ``faults.py`` plants the faults the check must catch.
Nothing here imports JAX or the JAX package.
"""
