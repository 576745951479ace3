"""RHAPSODY middleware core: tasks, services, resources, policies, coupling."""
from .autoscale import (AUTOSCALERS, Autoscaler, LatencySLOAutoscaler,
                        LatencyWindow, QueueDepthAutoscaler,
                        WeightedCapacityAutoscaler, autoscaler_from_policy)
from .middleware import Rhapsody
from .policy import ExecutionPolicy
from .request import (AdmissionDenied, InferenceRequest, RouteContext,
                      DEFAULT_CLASS_WEIGHTS)
from .resources import (Allocation, Claim, Placement, ResourceDescription,
                        partition)
from .service import (ModelGroup, ReplicaSet, ServiceDescription,
                      ServiceEndpoint, weighted_split)
from .task import (ResourceRequirements, Task, TaskDescription, TaskKind,
                   TaskState)

__all__ = [
    "Rhapsody", "ExecutionPolicy", "ResourceDescription", "Allocation",
    "Claim", "Placement", "partition", "ReplicaSet", "ServiceDescription",
    "ServiceEndpoint", "ModelGroup", "weighted_split",
    "AUTOSCALERS", "Autoscaler", "QueueDepthAutoscaler",
    "LatencySLOAutoscaler", "WeightedCapacityAutoscaler", "LatencyWindow",
    "autoscaler_from_policy",
    "TaskDescription", "TaskKind", "TaskState", "Task",
    "ResourceRequirements",
    "InferenceRequest", "RouteContext", "AdmissionDenied",
    "DEFAULT_CLASS_WEIGHTS",
]
