from .runner import FastskRunner, FastskRegressor, time_fastsk

__all__ = ["FastskRunner", "FastskRegressor", "time_fastsk"]
