"""Thread-safe singleton helper (reference:
``dlrover/python/common/singleton.py``).

Copy of ``dlrover_tpu/common/singleton.py``.
"""

import threading


class Singleton:
    _instance_lock = threading.Lock()
    _instance = None

    @classmethod
    def singleton_instance(cls, *args, **kwargs):
        if cls._instance is None or cls._instance.__class__ is not cls:
            with cls._instance_lock:
                if cls._instance is None or cls._instance.__class__ is not cls:
                    cls._instance = cls(*args, **kwargs)
        return cls._instance

    @classmethod
    def reset_singleton(cls):
        with cls._instance_lock:
            cls._instance = None
