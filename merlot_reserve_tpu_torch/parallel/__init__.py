from merlot_reserve_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    activate_mesh,
    current_mesh,
    make_mesh,
)
