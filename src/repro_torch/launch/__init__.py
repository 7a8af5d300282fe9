"""Launchers of the port: step builders (``steps``), the host-side page
allocator and priority scheduler (``paging``) and the continuous-batching
servers, dense and paged (``serve``)."""
