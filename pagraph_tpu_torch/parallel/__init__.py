"""Multi-device data parallelism, one process a rank (the port of
``pagraph_tpu/parallel/``, its ``cache`` feature source): the process
group and the ranks' launcher (:mod:`.multihost`), the gradient sync
(:mod:`.train_step`) and the trainer (:mod:`.dp_trainer`).  The halo
exchange and the JAX package's mesh helpers are not ported (ROADMAP queue
1 item 7c; a process group stands in for the mesh)."""
from .dp_trainer import DataParallelTrainer
from .multihost import init_distributed, is_multiprocess, spawn_local
from .train_step import GradSync, make_dp_train_step
