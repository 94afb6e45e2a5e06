from pigeon_tpu_torch.parallel.mesh import BatchedController, BatchState
