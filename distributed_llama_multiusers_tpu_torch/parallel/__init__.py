from .mesh import Mesh, MeshPlan, make_mesh, mesh_devices, validate_mesh_for_config
