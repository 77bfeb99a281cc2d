"""Command-line entry points of the port: ``serve`` (the LM engine) and, for now,
``train.preset_config`` only.

``launch/dryrun.py`` (XLA lowering on 512 fake devices) and the mesh
helpers (``mesh.py``, ``specs.py``) of the JAX package have no counterpart:
the port runs on one card.
"""
