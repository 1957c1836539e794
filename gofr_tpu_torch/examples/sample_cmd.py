"""The CLI example (copy of ``examples/sample-cmd/main.py``): sub-commands
sharing the transport-agnostic handler signature.

    python -m gofr_tpu_torch.examples.sample_cmd hello --name=x
"""

import gofr_tpu_torch


def hello(ctx):
    name = ctx.param("name")
    return f"Hello {name}!" if name else "Hello!"


def params(ctx):
    return f"Hello {ctx.param('name')}!"


def build():
    app = gofr_tpu_torch.new_cmd()
    app.sub_command("hello", hello)
    app.sub_command("params", params)
    return app


def main():
    build().run()


if __name__ == "__main__":
    main()
