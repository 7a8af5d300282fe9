"""Runners, one module per kind of traffic (the ``kind`` of a file in
``perfbench/traffic/``): each sets a cell up, runs its measured window,
and checks what the window produced against the reference."""
