"""Serving subsystem: batched generation + the query service.

* :class:`ServeEngine` / :class:`QueryServer` — in-process batch engines
  (:mod:`repro_torch.serve.engine`; ``ServeEngine`` imports torch only
  when it runs);
* :class:`BatchScheduler` — cross-request micro-batch windows with
  per-shard admission control, adaptive wait, and deadlines
  (:mod:`repro_torch.serve.scheduler`);
* :class:`ShardedQueryServer` — multi-process sharded serving with
  consistent-hash plane routing, shm payload transport, and a
  respawn-and-replay supervisor (:mod:`repro_torch.serve.shard`);
* :class:`QueryHTTPServer` / :class:`QueryClient` — the stdlib HTTP
  transport and its typed client (:mod:`repro_torch.serve.http` / ``client``),
  with :class:`RetryPolicy` for client-side backoff;
* :class:`TenantBackend` — one named tenant's engine/scheduler/follower
  stack behind a shared multi-tenant front (:mod:`repro_torch.serve.tenant`);
* :func:`warm_cache` — stats-driven startup plane preloading
  (:mod:`repro_torch.serve.warm`).
"""
from repro_torch.serve.client import (JSONClient, QueryClient, RequestFailed,
                                      RetryBudgetExceeded, RetryPolicy,
                                      ServerOverloaded, TransportError)
from repro_torch.serve.engine import (QueryError, QueryRequest, QueryServer,
                                      Request, ServeEngine)
from repro_torch.serve.http import QueryHTTPServer
from repro_torch.serve.scheduler import BatchScheduler, Overloaded
from repro_torch.serve.shard import ConsistentHashRing, ShardedQueryServer
from repro_torch.serve.tenant import TenantBackend, parse_tenant_arg
from repro_torch.serve.warm import plan_warm, warm_cache

__all__ = [
    "ServeEngine", "Request",
    "QueryServer", "QueryRequest", "QueryError",
    "BatchScheduler", "Overloaded",
    "ShardedQueryServer", "ConsistentHashRing",
    "QueryHTTPServer", "QueryClient", "JSONClient", "ServerOverloaded",
    "RequestFailed", "TransportError", "RetryPolicy", "RetryBudgetExceeded",
    "TenantBackend", "parse_tenant_arg",
    "plan_warm", "warm_cache",
]
