"""Multi-rank training over ``torch.distributed`` (counterpart of
``mtd_gan_tpu/parallel/``): the process grid and its collectives
(``mesh.py``) and the channel tensor-parallel generator (``tensor.py``)."""
