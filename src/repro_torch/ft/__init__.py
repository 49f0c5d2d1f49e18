from .elastic import RemeshPlan, plan_remesh
from .heartbeat import HeartbeatMonitor
from .straggler import StragglerDetector

__all__ = ["RemeshPlan", "plan_remesh", "HeartbeatMonitor",
           "StragglerDetector"]
