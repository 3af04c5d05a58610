from .html import HTML  # noqa: F401
from .images import save_image, save_images, tensor2im  # noqa: F401
from .visualizer import Visualizer  # noqa: F401
