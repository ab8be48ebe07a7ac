"""Fault tolerance and sharding for the port. Counterpart of
``repro/distributed``: ``fault`` (device-loss signalling, the step
watchdog and retry-from-checkpoint recovery), ``sharding`` (the
population and design-bank axis rules) and ``elastic`` (meshes over the
surviving devices)."""
