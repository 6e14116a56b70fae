from edsnet_torch.parallel.mesh import (make_mesh, replicate,  # noqa: F401
                                        shard_batch)
