"""Window drivers, one module per kind of window, found by the name a traffic
file's ``driver`` key gives."""
