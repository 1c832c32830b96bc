"""Distributed substrate of the port: logical-axis sharding on
torch.distributed, checkpointing, fault tolerance.

Models and the trainer name tensor dimensions with *logical* axes
("batch", "fsdp", "tp", "expert", "seq_sp"); `sharding` maps them to the
axes of whatever `DeviceMesh` the launcher installed. Off-mesh every
entry point is the one-device code.

  sharding.py     logical axes -> spec entries / DTensor placements,
                  the mesh context
  collectives.py  the explicit collectives over named mesh axes
  checkpoint.py   atomic directory-commit save/restore (optional async),
                  the reference's on-disk format
  fault.py        RestartManager (kill -9 survival), StepWatchdog,
                  reshard_restore (elastic mesh-to-mesh recovery),
                  HealthTracker
"""
from repro_torch.dist import checkpoint, fault, sharding  # noqa: F401
