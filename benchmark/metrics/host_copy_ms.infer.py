"""Device ms per batch of the host-to-device and device-to-host copies
(the model wrapper's uint8 wire, models/dehazing_model.py)."""


def read(summary, work):
    ms = sum(d for n, _, d in summary["ops"]
             if n.startswith(("Memcpy HtoD", "Memcpy DtoH"))) / 1e3
    return ms / summary["count"] if ms > 0 else None
