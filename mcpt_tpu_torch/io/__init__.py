from mcpt_tpu_torch.io.obj import load_obj
from mcpt_tpu_torch.io.png import read_png, write_png

__all__ = ["load_obj", "read_png", "write_png"]
