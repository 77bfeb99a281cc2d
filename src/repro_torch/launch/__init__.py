"""Command-line entry points of the port: ``serve`` (the LM engine),
``train`` (the fault-tolerant trainer, on one device or sharded over
ranks) and ``mesh`` (the ``DeviceMesh`` objects: the messaging ring's, the
trainer's ``(data, model)`` mesh, the production layout).

``launch/dryrun.py`` (XLA lowering on 512 fake devices) and ``specs.py`` of
the JAX package have no counterpart.
"""
