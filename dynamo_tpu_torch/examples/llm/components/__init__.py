from .frontend import Frontend
from .kv_router import Router
from .prefill_worker import PrefillWorker
from .processor import Processor
from .worker import GpuWorker

__all__ = ["Frontend", "Processor", "Router", "GpuWorker", "PrefillWorker"]
