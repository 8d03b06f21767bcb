"""One module a kind of traffic (``mixes/*.json``'s ``kind``)."""
