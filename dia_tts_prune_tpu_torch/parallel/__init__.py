"""Tensor-parallel serving over ``torch.distributed`` (``parallel/sharding.py``)."""
