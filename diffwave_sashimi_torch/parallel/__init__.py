"""Data-parallel training of the port (see :mod:`.mesh`)."""

from .mesh import (agree, all_reduce_mean, data_parallel, distributed,
                   is_main_process, launch, row_range, world_size)
