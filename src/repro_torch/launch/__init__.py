"""Launchers of the port: step builders (``steps``) and the
continuous-batching server (``serve``)."""
