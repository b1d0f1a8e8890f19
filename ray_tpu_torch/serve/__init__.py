"""ray_tpu_torch.serve: the serve control plane, the port of ray_tpu/serve.

A controller actor reconciles deployments into replica actors; handles
route requests with power-of-two choices and prefix or adapter affinity;
a standard-library HTTP proxy terminates HTTP; the queue and SLO
autoscalers resize replica sets, including replicas that reserve the card
(or a share of it) through ``ray_actor_options={"num_gpus": ...}``. The
reference's exports, less ``grpc_call`` and ``grpc_proxy_address``: the
port has no gRPC ingress (the card's machine has no ``grpcio``).
"""

from .api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    ingress,
    run,
    shutdown,
    start,
    status,
)
from .autoscale import AutoscalePolicy
from .batching import batch
from .config import AutoscalingConfig, DeploymentConfig, RequestRouterConfig
from .handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from .multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "batch",
    "multiplexed",
    "get_multiplexed_model_id",
    "deployment",
    "Deployment",
    "Application",
    "run",
    "start",
    "delete",
    "shutdown",
    "status",
    "get_app_handle",
    "get_deployment_handle",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "ingress",
    "AutoscalePolicy",
    "AutoscalingConfig",
    "DeploymentConfig",
    "RequestRouterConfig",
]
