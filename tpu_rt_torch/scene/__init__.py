from tpu_rt_torch.scene.objio import Mesh, Material, import_wavefront_mesh, export_wavefront_mesh
from tpu_rt_torch.scene.scene import Scene
from tpu_rt_torch.scene.camera import Camera
from tpu_rt_torch.scene.pixel_table import PixelTable
from tpu_rt_torch.scene import procedural

__all__ = [
    "Mesh",
    "Material",
    "import_wavefront_mesh",
    "export_wavefront_mesh",
    "Scene",
    "Camera",
    "PixelTable",
    "procedural",
]
