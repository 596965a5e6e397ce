"""repro_torch.api — the port's front door for alignment serving.

    from repro_torch.api import plan
    session = plan(W=64, O=24, k=12, backend="fused", rescue_rounds=2,
                   executor="thread")              # device="cuda"
    session.warmup([(10_000, 13_000)])       # prepare before traffic
    fut = session.submit(read_codes, ref_codes)
    ...
    print(fut.result()["cigar"], session.session_stats())
    session.close()                          # or use it as a context manager

For concurrent multi-tenant serving with SLOs (priority lanes, deadlines,
cancellation, load shedding), put a Gateway in front; it runs on the
session's device:

    gw = Gateway(session, GatewayPolicy(capacity=256))
    latency = gw.tenant("short-reads", priority=0, deadline_s=0.5)
    fut = latency.submit(read, ref)          # may raise ShedError
    fut.result(timeout=1.0)

``plan(..., device="cpu")`` runs the kernels' plain PyTorch versions; the
default is the card, and it raises where there is none.
"""
from .gateway import (DeadlineExceeded, Gateway, GatewayClosedError,
                      GatewayFuture, GatewayPolicy, ShedError, Tenant)
from .session import (AlignExecutable, AlignFuture, AlignSession, AlignSpec,
                      CompileCache, RequestCancelled, SessionPoisonedError,
                      plan, shared_compile_cache)

__all__ = ["AlignExecutable", "AlignFuture", "AlignSession", "AlignSpec",
           "CompileCache", "DeadlineExceeded", "Gateway",
           "GatewayClosedError", "GatewayFuture", "GatewayPolicy",
           "RequestCancelled", "SessionPoisonedError", "ShedError", "Tenant",
           "plan", "shared_compile_cache"]
