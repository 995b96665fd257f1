"""Event pipeline of the port: geometry, queues, conv unit, threshold
unit, plan, scheduler and network assembly."""
