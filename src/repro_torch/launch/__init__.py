"""Entry points of the port (``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve``) and its meshes."""
from repro_torch.launch.mesh import (
    host_layout, make_host_mesh, make_mesh, make_production_mesh,
    production_layout,
)
