"""Tensor-parallel serving and training over ``torch.distributed``
(``parallel/sharding.py``; the ranks of a one-command run: ``parallel/ranks.py``)."""
