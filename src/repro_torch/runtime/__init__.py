"""Runtime services of a training job."""
