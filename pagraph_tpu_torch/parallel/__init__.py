"""Multi-device data parallelism, one process a rank (the port of
``pagraph_tpu/parallel/``): the process group and the ranks' launchers
(:mod:`.multihost`: a function a rank, or a command a process), the
gradient sync and the halo step (:mod:`.train_step`), the features sharded
across the ranks and their exchange (:mod:`.halo`), and the trainer with
its ``cache``, ``ici`` and ``edge`` feature sources (:mod:`.dp_trainer`).  The JAX package's mesh
helpers are not ported: a process group stands in for the mesh."""
from .dp_trainer import DataParallelTrainer
from .multihost import init_distributed, is_multiprocess, spawn_commands, spawn_local
from .train_step import GradSync, make_dp_halo_train_step, make_dp_train_step
