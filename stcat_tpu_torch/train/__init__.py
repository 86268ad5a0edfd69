"""Training: the VideoSTG loss, the grouped optimizer with EMA, the train step."""
