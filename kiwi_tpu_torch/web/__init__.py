"""Web seismosizer (counterpart of web/cgi-bin/seismograms.pl; port of
kiwi_tpu/web)."""

from .server import SeismogramApp, serve

__all__ = ["SeismogramApp", "serve"]
