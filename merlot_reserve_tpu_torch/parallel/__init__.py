from merlot_reserve_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    activate_mesh,
    current_mesh,
    dp_anchor,
    make_mesh,
    row_shard_axes,
    rows_anchor,
)
