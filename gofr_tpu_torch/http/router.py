"""Method + path router with ``{param}`` segments and a middleware chain.

Parity: GoFr's pkg/gofr/http/router.go:13-33 — gorilla/mux-style
routes with path variables, middleware installed once at startup
(router.go:19-23), per-route span wrapping (router.go:31, done by the
middleware chain here). Matching is segment-wise against a precompiled
table; no regex on the hot path.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Optional

from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.response import Response

# An endpoint is the fully-adapted async callable the server dispatches to.
Endpoint = Callable[[Request], Awaitable[Response]]
Middleware = Callable[[Endpoint], Endpoint]


class _Route:
    __slots__ = ("method", "segments", "endpoint", "pattern")

    def __init__(self, method: str, pattern: str, endpoint: Endpoint):
        self.method = method.upper()
        self.pattern = pattern
        self.segments = _split(pattern)
        self.endpoint = endpoint

    def match(self, segments: list[str]) -> Optional[dict[str, str]]:
        if len(segments) != len(self.segments):
            return None
        params: dict[str, str] = {}
        for want, got in zip(self.segments, segments):
            if want.startswith("{") and want.endswith("}"):
                params[want[1:-1]] = got
            elif want != got:
                return None
        return params


def _split(path: str) -> list[str]:
    # strict-slash off (router.go:17): /abc and /abc/ are the same route
    return [s for s in path.split("/") if s != ""]


class Router:
    def __init__(self) -> None:
        self._routes: list[_Route] = []
        self._middleware: list[Middleware] = []
        self._not_found: Optional[Endpoint] = None
        self._dispatch: Optional[Endpoint] = None

    def add(self, method: str, pattern: str, endpoint: Endpoint) -> None:
        self._routes.append(_Route(method, pattern, endpoint))
        self._dispatch = None  # route table changed; recompose

    def set_not_found(self, endpoint: Endpoint) -> None:
        """Catch-all handler (parity: handler.go:51 catchAllHandler)."""
        self._not_found = endpoint
        self._dispatch = None

    def use(self, *middleware: Middleware) -> None:
        """Install middleware, outermost first (router.go:19-23)."""
        self._middleware.extend(middleware)
        self._dispatch = None

    def routes(self) -> list[tuple[str, str]]:
        return [(r.method, r.pattern) for r in self._routes]

    async def _route_endpoint(self, request: Request) -> Response:
        segments = _split(request.path)
        method = "GET" if request.method == "HEAD" else request.method
        allowed: list[str] = []
        for route in self._routes:
            params = route.match(segments)
            if params is None:
                continue
            # the MATCHED ROUTE PATTERN (bounded cardinality), never the
            # raw URL: middleware (metrics path label) reads it after
            # dispatch. Set on the 405 path too — the path existed.
            request.route_pattern = route.pattern
            if route.method == method:
                request.path_params = params
                return await route.endpoint(request)
            allowed.append(route.method)
        if allowed:
            return Response(
                status=405,
                headers={"Allow": ", ".join(sorted(set(allowed))),
                         "Content-Type": "application/json"},
                body=b'{"error":{"message":"method not allowed"}}',
            )
        if self._not_found is not None:
            return await self._not_found(request)
        return Response(status=404)

    def dispatcher(self) -> Endpoint:
        """Compose middleware around routing; cached until routes change."""
        if self._dispatch is None:
            endpoint: Endpoint = self._route_endpoint
            for mw in reversed(self._middleware):
                endpoint = mw(endpoint)
            self._dispatch = endpoint
        return self._dispatch
