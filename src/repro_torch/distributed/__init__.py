from repro_torch.distributed.coordinator import (Coordinator,
                                                 CoordinatorConfig, HostState)
from repro_torch.distributed.elastic import (elastic_mesh_shapes, shrink_mesh,
                                             survivors)
