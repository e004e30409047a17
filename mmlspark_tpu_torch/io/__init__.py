"""Model serving of the port: HTTP in, the compiled plan, HTTP out.

Ports of the reference's `io/serving.py` (`ServingServer`,
`ServingQuery`, `serve_pipeline`, `Reply`), `io/plan.py`
(`ServingTransform`, `compile_serving_transform`) and `io/loadgen.py`
(`run_load`). The reference's HTTP client transformers, Power BI writer,
file streams and shared variables (`http.py`, `powerbi.py`,
`streaming.py`, `sources.py`, `shared.py`) are ROADMAP Queue 1 item 27:
importing one of their names or modules raises NotImplementedError
naming the item. The service registry and distributed serving
(`registry.py`) are ported.
"""
from .plan import ServingTransform, compile_serving_transform
from .registry import (RegistryClient, ServiceInfo, ServiceRegistry,
                       list_services, report_server_to_registry,
                       start_distributed_serving)
from .serving import Reply, ServingQuery, ServingServer, serve_pipeline

_NOT_PORTED = {
    **{n: "27" for n in (
        "HTTPTransformer", "SimpleHTTPTransformer", "JSONInputParser",
        "JSONOutputParser", "StringOutputParser", "CustomInputParser",
        "CustomOutputParser", "PartitionConsolidator", "HTTPRequest",
        "HTTPResponse", "FileStreamQuery", "FileStreamSource",
        "SharedVariable", "shared_singleton", "ForwardedPort",
        "forward_port_to_remote")},
}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"io.{name} is not ported yet (ROADMAP Queue 1 item "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Reply", "ServingServer", "ServingQuery", "serve_pipeline",
           "ServingTransform", "compile_serving_transform",
           "RegistryClient", "ServiceInfo", "ServiceRegistry",
           "list_services", "report_server_to_registry",
           "start_distributed_serving"]
