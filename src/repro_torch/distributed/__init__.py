"""Fault tolerance and sharding for the port. Counterpart of
``repro/distributed``: ``fault`` (device-loss signalling, the step
watchdog and retry-from-checkpoint recovery), ``sharding`` (the LM
parameter and batch rules, the population and design-bank axis rules)
and ``elastic`` (meshes over the surviving devices, ``reshard_state``)."""
