from .misc import AverageMeter, Timer, device_memory_stats, set_seeds

__all__ = ["AverageMeter", "Timer", "device_memory_stats", "set_seeds"]
