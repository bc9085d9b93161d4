"""Serving: the streaming hop, deploy compilation and the session pool."""

from repro_torch.serve.deploy import DeployPlan, build_deploy_plan, stream_hop_fused
from repro_torch.serve.session_server import PoolFullError, Session, SessionError, SessionPool
from repro_torch.serve.streaming_se import StreamState, init_stream, make_stream_hop, reset_slots

__all__ = [
    "DeployPlan", "PoolFullError", "Session", "SessionError", "SessionPool", "StreamState",
    "build_deploy_plan", "init_stream", "make_stream_hop", "reset_slots", "stream_hop_fused",
]
