from repro_torch.train.loop import Trainer, TrainerConfig, TrainState, make_train_step
