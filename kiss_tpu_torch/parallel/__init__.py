from kiss_tpu_torch.parallel.fm_sharded import (  # noqa: F401
    shard_fm_arrays,
    sharded_get_ranges,
    sharded_locate_rows,
)
from kiss_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    sharded_batch_query,
    sharded_pipeline_step,
    sharded_suffix_sort,
)
