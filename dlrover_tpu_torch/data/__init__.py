"""The input data plane of the port (``dlrover_tpu/data``)."""

from dlrover_tpu_torch.data.elastic_dataloader import (  # noqa: F401
    ElasticDataLoader,
)
from dlrover_tpu_torch.data.prefetch import (  # noqa: F401
    batch_nbytes,
    device_prefetch,
    host_prefetch,
)
from dlrover_tpu_torch.data.shm_dataloader import (  # noqa: F401
    ShmDataLoader,
    ShmBatchWriter,
    ShmSlotTimeout,
)
from dlrover_tpu_torch.data.coworker import (  # noqa: F401
    CoworkerClient,
    CoworkerDataset,
    CoworkerServer,
)
