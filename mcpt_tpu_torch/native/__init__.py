from mcpt_tpu_torch.native.native import bvh_build_native, native_available, obj_load_native

__all__ = ["native_available", "obj_load_native", "bvh_build_native"]
