"""The port's gRPC transport (``gofr_tpu_torch/grpcx.py``) over a real
in-process server and channel, case for case with ``tests/test_grpc.py``,
then beside the JAX package's server: the same handler results give the
same response bytes and status codes, and the port's ``App`` starts and
stops the server on ``GRPC_PORT``."""

import json

import grpc
import pytest

from gofr_tpu_torch.config import EnvFileConfig as EnvConfig
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.errors import EntityNotFoundError
from gofr_tpu_torch.grpcx import GRPCServer
from gofr_tpu_torch.testutil import MockLogger


@pytest.fixture
def server(free_port):
    port = free_port()
    container = Container(EnvConfig(), wire=False)
    container.logger = MockLogger()

    def say_hello(ctx):
        name = ctx.param("name") or "World"
        return f"Hello {name}!"

    def not_found(ctx):
        raise EntityNotFoundError("user", ctx.param("id"))

    def panics(ctx):
        raise RuntimeError("secret internals")

    srv = GRPCServer(
        port,
        container,
        json_services={
            "HelloService": {"SayHello": say_hello, "Lookup": not_found, "Panic": panics}
        },
    )
    srv.start()
    yield port, container
    srv.stop()


def _call(port, method, payload, metadata=None):
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = channel.unary_unary(
            f"/HelloService/{method}",
            request_serializer=None,
            response_deserializer=None,
        )
        return stub(json.dumps(payload).encode(), metadata=metadata, timeout=5)


def test_json_unary_call(server):
    port, _ = server
    resp = json.loads(_call(port, "SayHello", {"name": "ada"}))
    assert resp == {"data": "Hello ada!"}


def test_typed_error_maps_to_grpc_status(server):
    port, _ = server
    with pytest.raises(grpc.RpcError) as exc:
        _call(port, "Lookup", {"id": "9"})
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND
    assert "No 'user' found" in exc.value.details()


def test_unknown_error_hides_internals(server):
    port, container = server
    with pytest.raises(grpc.RpcError) as exc:
        _call(port, "Panic", {})
    assert exc.value.code() == grpc.StatusCode.INTERNAL
    assert "secret internals" not in exc.value.details()
    assert "secret internals" in container.logger.output  # logged server-side


def test_unknown_method_unimplemented(server):
    port, _ = server
    with pytest.raises(grpc.RpcError) as exc:
        _call(port, "Nope", {})
    assert exc.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_rpc_log_emitted(server):
    port, container = server
    _call(port, "SayHello", {"name": "x"})
    assert "/HelloService/SayHello" in container.logger.output


def test_invalid_json_payload(server):
    port, _ = server
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = channel.unary_unary("/HelloService/SayHello")
        with pytest.raises(grpc.RpcError) as exc:
            stub(b"\xff\xfe not json", timeout=5)
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


# -- server-streaming JSON services (token decode transport) ------------------

@pytest.fixture
def stream_server(free_port):
    port = free_port()
    container = Container(EnvConfig(), wire=False)
    container.logger = MockLogger()

    def countdown(ctx):
        n = int(ctx.param("n") or 3)
        for i in range(n, 0, -1):
            yield {"tick": i}

    def stream_fails(ctx):
        yield {"tick": 1}
        raise RuntimeError("decode blew up")

    def bad_request(ctx):
        from gofr_tpu_torch.errors import InvalidParamError

        raise InvalidParamError("n")
        yield  # makes it a generator-shaped handler

    srv = GRPCServer(
        port,
        container,
        json_services={"Clock": {"Now": lambda ctx: "now"}},
        json_stream_services={
            "Clock": {"Countdown": countdown, "Broken": stream_fails, "Bad": bad_request}
        },
    )
    srv.start()
    yield port, container
    srv.stop()


def _stream(port, method, payload):
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = channel.unary_stream(f"/Clock/{method}")
        return [json.loads(m) for m in stub(json.dumps(payload).encode(), timeout=10)]


def test_json_stream_messages(stream_server):
    port, _ = stream_server
    assert _stream(port, "Countdown", {"n": 3}) == [
        {"tick": 3}, {"tick": 2}, {"tick": 1},
    ]


def test_unary_and_stream_share_service_name(stream_server):
    port, _ = stream_server
    assert json.loads(_call_service(port, "Clock", "Now", {})) == {"data": "now"}


def test_stream_midstream_error_aborts(stream_server):
    port, container = stream_server
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = channel.unary_stream("/Clock/Broken")
        it = stub(b"{}", timeout=10)
        assert json.loads(next(it)) == {"tick": 1}
        with pytest.raises(grpc.RpcError) as exc:
            list(it)
    assert exc.value.code() == grpc.StatusCode.INTERNAL
    assert "decode blew up" not in exc.value.details()
    assert "decode blew up" in container.logger.output


def test_stream_typed_error_maps_status(stream_server):
    port, _ = stream_server
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = channel.unary_stream("/Clock/Bad")
        with pytest.raises(grpc.RpcError) as exc:
            list(stub(b"{}", timeout=10))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def _call_service(port, service, method, payload):
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        stub = channel.unary_unary(f"/{service}/{method}")
        return stub(json.dumps(payload).encode(), timeout=5)


def test_duplicate_unary_and_stream_method_rejected(free_port):
    container = Container(EnvConfig(), wire=False)
    container.logger = MockLogger()
    with pytest.raises(ValueError, match="both"):
        GRPCServer(
            free_port(),
            container,
            json_services={"S": {"Gen": lambda ctx: 1}},
            json_stream_services={"S": {"Gen": lambda ctx: iter(())}},
        )


# -- generated-stub path -------------------------------------------------------

def _load_hello_stubs():
    """The port's copy of the example's generated protoc modules."""
    from gofr_tpu_torch.examples.pb import hello_pb2, hello_pb2_grpc

    return hello_pb2, hello_pb2_grpc


def test_generated_stub_service(free_port):
    """app.register_service wiring: a protoc-generated servicer served and
    called through the generated client stub — real proto bytes on the
    wire, not JSON."""
    hello_pb2, hello_pb2_grpc = _load_hello_stubs()

    class Servicer(hello_pb2_grpc.HelloServicer):
        def SayHello(self, request, context):
            return hello_pb2.HelloResponse(
                message=f"Hello {request.name or 'World'}!"
            )

    port = free_port()
    container = Container(EnvConfig(), wire=False)
    container.logger = MockLogger()
    srv = GRPCServer(
        port, container,
        registrations=[(hello_pb2_grpc.add_HelloServicer_to_server, Servicer())],
    )
    srv.start()
    try:
        with grpc.insecure_channel(f"localhost:{port}") as channel:
            stub = hello_pb2_grpc.HelloStub(channel)
            reply = stub.SayHello(
                hello_pb2.HelloRequest(name="ada"), timeout=5
            )
            assert reply.message == "Hello ada!"
            reply = stub.SayHello(hello_pb2.HelloRequest(), timeout=5)
            assert reply.message == "Hello World!"
    finally:
        srv.stop()


def test_generated_stub_rpc_is_logged(free_port):
    """The interceptor chain (recovery -> RPCLog) wraps generated-stub
    services exactly as JSON ones (parity: grpc/log.go:27-50)."""
    hello_pb2, hello_pb2_grpc = _load_hello_stubs()

    class Servicer(hello_pb2_grpc.HelloServicer):
        def SayHello(self, request, context):
            return hello_pb2.HelloResponse(message="hi")

    port = free_port()
    container = Container(EnvConfig(), wire=False)
    container.logger = MockLogger()
    srv = GRPCServer(
        port, container,
        registrations=[(hello_pb2_grpc.add_HelloServicer_to_server, Servicer())],
    )
    srv.start()
    try:
        with grpc.insecure_channel(f"localhost:{port}") as channel:
            hello_pb2_grpc.HelloStub(channel).SayHello(
                hello_pb2.HelloRequest(name="x"), timeout=5
            )
    finally:
        srv.stop()
    assert container.logger.contains("/hello.Hello/SayHello")
    assert container.logger.contains('"status": "OK"')


# -- the two packages side by side --------------------------------------------

import gofr_tpu.grpcx as jax_grpcx  # noqa: E402
import gofr_tpu_torch.grpcx as torch_grpcx  # noqa: E402
from gofr_tpu.config import EnvConfig as JaxEnvConfig  # noqa: E402
from gofr_tpu.container import Container as JaxContainer  # noqa: E402
from gofr_tpu.testutil import MockLogger as JaxMockLogger  # noqa: E402


def _handlers(errors):
    def unary(ctx):
        kind = ctx.param("kind")
        if kind == "str":
            return "Hello ü!"
        if kind == "dict":
            return {"b": [1, 2.5, None, True], "a": {"x": "ü"}, "n": ctx.param("n")}
        if kind == "none":
            return None
        if kind == "list":
            return [ctx.param("n"), ctx.header("x-meta"), ctx.params("n")]
        if kind == "bytes":
            return b"raw"
        raise getattr(errors, kind)("thing") if kind != "panic" else RuntimeError("secret")

    def stream(ctx):
        for i in range(int(ctx.param("n") or 3)):
            yield {"token": i, "text": "ü" * i}
        if ctx.param("fail"):
            raise errors.InvalidParamError("n")

    return {"Echo": unary}, {"Gen": stream}


@pytest.fixture
def both_servers(free_port):
    """The same JSON service served by the JAX server and by the port's."""
    import gofr_tpu.errors as jax_errors
    import gofr_tpu_torch.errors as torch_errors

    servers = []
    for grpcx, container, errors, logger in (
        (jax_grpcx, JaxContainer(JaxEnvConfig(), wire=False), jax_errors, JaxMockLogger()),
        (torch_grpcx, Container(EnvConfig(), wire=False), torch_errors, MockLogger()),
    ):
        container.logger = logger
        unary, stream = _handlers(errors)
        port = free_port()
        srv = grpcx.GRPCServer(port, container, json_services={"Svc": unary},
                               json_stream_services={"Svc": stream})
        srv.start()
        servers.append((port, srv, container))
    yield servers
    for _, srv, container in servers:
        srv.stop()
        container.close()


def _raw(port, method, payload, metadata=None, stream=False):
    """The response bytes (or the error's code and details) as a raw
    client reads them."""
    with grpc.insecure_channel(f"localhost:{port}") as channel:
        try:
            if stream:
                call = channel.unary_stream(f"/Svc/{method}")
                return [bytes(m) for m in call(payload, metadata=metadata, timeout=10)]
            call = channel.unary_unary(f"/Svc/{method}")
            return bytes(call(payload, metadata=metadata, timeout=10))
        except grpc.RpcError as exc:
            return (exc.code(), exc.details())


@pytest.mark.parametrize("kind", [
    "str", "dict", "none", "list", "bytes", "panic", "EntityNotFoundError",
    "InvalidParamError", "UnauthenticatedError", "TooManyRequestsError",
])
def test_json_response_bytes_equal_jax(both_servers, kind):
    payload = json.dumps({"kind": kind, "n": "7"}).encode()
    meta = (("x-meta", "m"),)
    answers = [_raw(port, "Echo", payload, meta) for port, _, _ in both_servers]
    assert answers[1] == answers[0]
    if kind in ("str", "dict", "none", "list"):
        assert isinstance(answers[0], bytes) and answers[0].startswith(b'{"data"')


@pytest.mark.parametrize("payload", [
    b'{"n": 4}', b'{"n": 2, "fail": "1"}', b"not json", b"[1, 2]", b"",
])
def test_stream_bytes_equal_jax(both_servers, payload):
    answers = [_raw(port, "Gen", payload, stream=True) for port, _, _ in both_servers]
    assert answers[1] == answers[0]


def test_status_map_equals_jax():
    """Every HTTP status maps to the JAX server's gRPC code."""
    for status in range(100, 600):
        assert torch_grpcx._status_to_grpc(status) == jax_grpcx._status_to_grpc(status), status


def test_rpc_log_and_request_equal_jax():
    ours = torch_grpcx.RPCLog("abc", "/Svc/Echo", "OK", 12)
    theirs = jax_grpcx.RPCLog("abc", "/Svc/Echo", "OK", 12)
    assert ours.log_fields() == theirs.log_fields()
    assert ours.pretty_terminal() == theirs.pretty_terminal()
    meta = {"x-a": "1"}
    for payload in ({"a": "1", "b": 2, "c": [1, 2]}, None, [1, 2]):
        mine = torch_grpcx.GRPCRequest("/Svc/Echo", payload, meta)
        ref = jax_grpcx.GRPCRequest("/Svc/Echo", payload, meta)
        for key in ("a", "b", "c", "z"):
            assert mine.param(key) == ref.param(key)
            assert mine.params(key) == ref.params(key)
        assert mine.bind() == ref.bind() and mine.header("x-a") == ref.header("x-a")
        assert mine.host_name() == ref.host_name()


def test_app_serves_grpc_on_grpc_port(monkeypatch, tmp_path, free_port):
    """``App.register_service`` and ``register_json_service`` on the
    port's app: ``start`` serves both on ``GRPC_PORT`` beside HTTP,
    ``shutdown`` stops it; a method in both maps is refused."""
    import gofr_tpu_torch

    hello_pb2, hello_pb2_grpc = _load_hello_stubs()
    for key in ("REDIS_HOST", "DB_NAME", "DB_HOST", "TPU_ENABLED", "MODEL_NAME"):
        monkeypatch.delenv(key, raising=False)
    grpc_port = free_port()
    monkeypatch.setenv("HTTP_PORT", str(free_port()))
    monkeypatch.setenv("GRPC_PORT", str(grpc_port))
    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.chdir(tmp_path)
    app = gofr_tpu_torch.new()

    class Servicer(hello_pb2_grpc.HelloServicer):
        def SayHello(self, request, context):
            return hello_pb2.HelloResponse(message=f"Hello {request.name}!")

    app.register_service(hello_pb2_grpc.add_HelloServicer_to_server, Servicer())
    app.register_json_service("HelloService", {"SayHello": lambda ctx: f"Hi {ctx.param('name')}"},
                              stream_methods={"Count": lambda ctx: iter([{"i": 0}, {"i": 1}])})
    with pytest.raises(ValueError, match="both"):
        app.register_json_service("S", {"X": lambda c: 1}, stream_methods={"X": lambda c: iter(())})
    assert app.grpc_port == grpc_port
    app.start()
    try:
        with grpc.insecure_channel(f"localhost:{grpc_port}") as channel:
            reply = hello_pb2_grpc.HelloStub(channel).SayHello(
                hello_pb2.HelloRequest(name="ada"), timeout=5)
            assert reply.message == "Hello ada!"
            unary = channel.unary_unary("/HelloService/SayHello")
            assert json.loads(unary(b'{"name": "bo"}', timeout=5)) == {"data": "Hi bo"}
            count = channel.unary_stream("/HelloService/Count")
            assert [json.loads(m) for m in count(b"{}", timeout=5)] == [{"i": 0}, {"i": 1}]
    finally:
        app.shutdown()
    with grpc.insecure_channel(f"localhost:{grpc_port}") as channel:
        with pytest.raises(grpc.RpcError):
            channel.unary_unary("/HelloService/SayHello")(b"{}", timeout=2)
