"""Multi-device helpers of the port (``torch.distributed``)."""
