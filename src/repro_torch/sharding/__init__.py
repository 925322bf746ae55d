"""The sharding plans and the activation-sharding context on a
``torch.distributed`` DeviceMesh (the port of ``repro.sharding``)."""
