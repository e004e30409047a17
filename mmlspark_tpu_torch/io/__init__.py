"""IO layer of the port: HTTP client transformers, model serving, file
sources and streams, writers and shared variables (reference: io/ —
SURVEY.md §2.6/§2.7).

Ports of the reference's `io/serving.py` (`ServingServer`,
`ServingQuery`, `serve_pipeline`, `Reply`), `io/plan.py`
(`ServingTransform`, `compile_serving_transform`), `io/loadgen.py`
(`run_load`), `io/registry.py` (the service registry and distributed
serving), `io/http.py` (the client transformers and parsers),
`io/streaming.py` (the epoch-replayed file streams), `io/sources.py`
(`read_csv`, `read_binary_files`, `read_images`, which decodes PNG and
sequential JPEG on the card through `image/decode.py`), `io/powerbi.py`
and `io/shared.py`.
"""
from .http import (HTTPTransformer, SimpleHTTPTransformer, JSONInputParser,
                   JSONOutputParser, StringOutputParser, CustomInputParser,
                   CustomOutputParser, PartitionConsolidator, HTTPRequest,
                   HTTPResponse)
from .serving import Reply, ServingServer, serve_pipeline, ServingQuery
from .plan import ServingTransform, compile_serving_transform
from .streaming import FileStreamQuery, FileStreamSource
from .registry import (RegistryClient, ServiceInfo, ServiceRegistry,
                       list_services, report_server_to_registry,
                       start_distributed_serving)
from .shared import (ForwardedPort, SharedVariable, forward_port_to_remote,
                     shared_singleton)

__all__ = ["HTTPTransformer", "SimpleHTTPTransformer", "JSONInputParser",
           "JSONOutputParser", "StringOutputParser", "CustomInputParser",
           "CustomOutputParser", "PartitionConsolidator", "HTTPRequest",
           "HTTPResponse", "ServingServer", "serve_pipeline", "ServingQuery",
           "Reply", "ServingTransform", "compile_serving_transform",
           "RegistryClient", "ServiceInfo", "ServiceRegistry",
           "list_services", "report_server_to_registry",
           "start_distributed_serving",
           "FileStreamQuery", "FileStreamSource",
           "SharedVariable", "shared_singleton", "ForwardedPort",
           "forward_port_to_remote"]
