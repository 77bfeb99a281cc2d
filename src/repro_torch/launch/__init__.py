"""Command-line entry points of the port: ``serve`` (the LM engine),
``train`` (the fault-tolerant trainer) and ``mesh`` (the ``DeviceMesh`` of
the messaging ring).

``launch/dryrun.py`` (XLA lowering on 512 fake devices) and ``specs.py`` of
the JAX package have no counterpart.
"""
