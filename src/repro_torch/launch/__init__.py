"""Command-line entry points of the port: ``serve`` (the LM engine),
``train`` (the fault-tolerant trainer, on one device or sharded over
ranks), ``dryrun`` (every production cell as one rank, on fake tensors over
a fake process group: per-rank memory, FLOPs, bytes and collectives) with
its cell builders ``specs``, and ``mesh`` (the ``DeviceMesh`` objects: the
messaging ring's, the trainer's ``(data, model)`` mesh, the production
layout, the fake world).
"""
