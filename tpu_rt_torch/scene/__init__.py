from tpu_rt_torch.scene.objio import Mesh, Material
from tpu_rt_torch.scene.scene import Scene
from tpu_rt_torch.scene.camera import Camera
from tpu_rt_torch.scene.pixel_table import PixelTable
from tpu_rt_torch.scene import procedural

__all__ = ["Mesh", "Material", "Scene", "Camera", "PixelTable", "procedural"]
