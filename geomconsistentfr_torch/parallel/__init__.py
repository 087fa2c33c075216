"""Multi-process execution on torch.distributed: process setup and the rank mesh."""
