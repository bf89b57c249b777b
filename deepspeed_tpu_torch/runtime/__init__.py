"""Training runtime: engine, optimizer, LR schedules, loss scaling."""
