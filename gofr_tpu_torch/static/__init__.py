"""Embedded static assets (copy of ``gofr_tpu/static/``): the favicon
served at ``/favicon.ico``, shipped inside the package and read through
importlib.resources."""

from importlib import resources


def favicon() -> bytes:
    return resources.files(__package__).joinpath("favicon.ico").read_bytes()
