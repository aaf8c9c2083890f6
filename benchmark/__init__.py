"""The benchmark of ``ska_sdp_tpu_torch`` on one NVIDIA GPU.

``benchmark/run.py`` runs one cell of ``BENCHMARK.json``; ``README.md``
says how to run it and how to add a configuration, a traffic mix or a
per-layer metric as new files.  Nothing here imports ``jax`` or the JAX
package ``ska_sdp_tpu``; ``benchmark/reference/`` imports nothing of
``ska_sdp_tpu_torch`` either.
"""
