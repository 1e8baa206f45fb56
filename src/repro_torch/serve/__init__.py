from .engine import ADMISSION_BUCKET, Engine, ServeConfig
from .kv import DenseKV, Prefix

__all__ = ["ADMISSION_BUCKET", "Engine", "ServeConfig", "DenseKV", "Prefix"]
