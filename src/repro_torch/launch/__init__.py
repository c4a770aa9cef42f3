"""Step functions and drivers: training steps, the serving driver."""
