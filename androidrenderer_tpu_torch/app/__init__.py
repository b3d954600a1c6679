"""Application layer — tick loop, scene management, flycam (core/application.cpp)."""

from androidrenderer_tpu_torch.app.application import Application

__all__ = ["Application"]
