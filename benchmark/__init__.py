"""The benchmark of the PyTorch and CUDA port (``ggrs_tpu_torch``).

``run.py`` is the command; see its docstring.  Everything that measures or
judges lives here, so that no change to the program moves the yardstick."""
