"""Traffic drivers (``<driver>.py``) and the mixes they read
(``<mix>.json``)."""
