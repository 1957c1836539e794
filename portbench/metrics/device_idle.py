"""Share of the traced window in which no operation ran on the card, in %.
Layer: the device. Read for any cell; its metric's name gives the cell's
end-to-end metric it moves (``device_idle.<cell>``)."""

from portbench.readings import device_idle


def read(run: dict):
    return device_idle(run)
