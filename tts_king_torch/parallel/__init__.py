"""Data, tensor and sequence parallelism on torch.distributed: the
multi-process startup (lockstep), the dp x tp mesh and its sharding rules
(mesh), the collectives (comm) and a local launcher (launch)."""
