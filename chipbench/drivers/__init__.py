"""One driver per kind of window (``traffic/<mix>.json``'s ``kind``)."""
