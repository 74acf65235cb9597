"""The benchmark's yardstick: what it reads, computes and prints.

Nothing here imports JAX or the JAX package.  The system under test
(``byol_tpu_torch``) is imported only by the drivers (drivers/), and only
inside the functions that run a cell.
"""
