"""Fault tolerance for the port's serving tier. Counterpart of
``repro/distributed``: ``fault`` (device-loss signalling, the step
watchdog and retry-from-checkpoint recovery). Sharding and elastic
meshes (``sharding.py``, ``elastic.py``) belong to ROADMAP A9b."""
