"""HTTP transport: asyncio HTTP/1.1 server, router, request, responder,
response types and the middleware chain (copied from ``gofr_tpu/http/``)."""

from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.response import File, Raw, Response, Stream
from gofr_tpu_torch.http.responder import respond
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer

__all__ = ["Request", "Response", "Raw", "File", "Stream", "respond", "Router", "HTTPServer"]
