"""Runtime abstractions the engine plugs into."""
