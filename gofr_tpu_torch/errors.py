"""Error types with HTTP status mapping (trimmed copy of
``gofr_tpu/errors.py``): any exception carrying ``status_code`` maps to
that status, everything else is a 500."""

from __future__ import annotations


class GofrError(Exception):
    status_code: int = 500

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message or self.__class__.__name__

    def __str__(self) -> str:
        return self.message


class InvalidParamError(GofrError):
    """Bad request parameter -> 400, in the JAX package's words:
    ``'1' invalid parameter <what>``."""

    status_code = 400

    def __init__(self, *params: str):
        self.params = list(params)
        noun = "parameter" if len(self.params) == 1 else "parameters"
        super().__init__(f"'{len(self.params)}' invalid {noun} {', '.join(self.params)}")


class MissingParamError(GofrError):
    """A required request parameter is absent -> 400:
    ``'1' missing parameter <what>``."""

    status_code = 400

    def __init__(self, *params: str):
        self.params = list(params)
        noun = "parameter" if len(self.params) == 1 else "parameters"
        super().__init__(f"'{len(self.params)}' missing {noun} {', '.join(self.params)}")


class UnauthenticatedError(GofrError):
    """Missing or wrong credentials -> 401."""

    status_code = 401


class ForbiddenError(GofrError):
    """Authenticated but not allowed -> 403."""

    status_code = 403

    def __init__(self, message: str = "forbidden"):
        super().__init__(message)


class RequestTimeoutError(GofrError):
    """The request took too long -> 408."""

    status_code = 408

    def __init__(self, message: str = "request timed out"):
        super().__init__(message)


class EntityNotFoundError(GofrError):
    """Row/key not found -> 404."""

    status_code = 404

    def __init__(self, name: str = "entity", value: str = ""):
        super().__init__(f"No '{name}' found for value '{value}'")


class RouteNotFoundError(GofrError):
    status_code = 404

    def __init__(self) -> None:
        super().__init__("route not registered")


class TooManyRequestsError(GofrError):
    """Batch queue overflow -> 429."""

    status_code = 429

    def __init__(self, message: str = "server overloaded"):
        super().__init__(message)


class DeadlineExceeded(GofrError):
    """The request's end-to-end deadline expired before or while it was
    served -> 504. ``stage`` says where the budget ran out (queue |
    admission | decode), the label of
    ``gofr_tpu_deadline_exceeded_total{stage}``."""

    status_code = 504

    def __init__(self, message: str = "request deadline exceeded", stage: str = ""):
        super().__init__(message)
        self.stage = stage


class HTTPError(GofrError):
    """Arbitrary status escape hatch."""

    def __init__(self, status_code: int, message: str):
        self.status_code = status_code
        super().__init__(message)


def status_from_error(err: BaseException | None) -> int:
    if err is None:
        return 200
    code = getattr(err, "status_code", None)
    if isinstance(code, int) and 100 <= code <= 599:
        return code
    return 500
