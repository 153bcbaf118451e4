"""Launch-side helpers of the port: per-executable memory
(``launch.memory``), the emulated named grids (``launch.mesh``), the
shape suite and abstract trees on the ``meta`` device (``launch.specs``),
the dry run of every cell on that device and its roofline
(``launch.dryrun``, ``launch.hlo_analysis``; run it with ``python -m
repro_torch.launch.dryrun``), the training launcher (``launch.train``)
and the
multi-process fleet (``launch.multiprocess``: ``initialize``,
``launch_local``, ``worker_smoke``, ``Supervisor``; run it with ``python
-m repro_torch.launch.multiprocess``, which is why its names load on
first use here)."""

_FLEET = ("initialize", "shutdown", "worker_smoke", "launch_local",
          "Heartbeat", "Supervisor", "SupervisorPolicy", "write_heartbeat",
          "read_heartbeat", "heartbeat_path")


def __getattr__(name):
    if name in _FLEET:
        from . import multiprocess

        return getattr(multiprocess, name)
    raise AttributeError(
        f"module 'repro_torch.launch' has no attribute {name!r}")
