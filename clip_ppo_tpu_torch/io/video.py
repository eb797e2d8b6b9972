"""Episode video capture for device-resident envs (RecordVideo equivalent).

The reference wraps host env 0 in ``gym.wrappers.RecordVideo``
(`ppo_minigrid.py:115-116`, `clip_ppo_atari.py:151-153`), recording
episodes on gymnasium's capped-cubic schedule into ``videos/...``. Here
envs live on the accelerator, so capture works on the rollout batch the
training iteration already produces: the trainer surfaces env 0's frames
([T, H, W, C] uint8, one device→host copy per iteration, only when
enabled), and this recorder splits them at episode boundaries and encodes
scheduled episodes as ``rl-video-episode-{k}.mp4`` via OpenCV's mp4v
writer (the reference's RecordVideo artifact name,
`ppo_minigrid.py:115-116`), falling back to an animated GIF via PIL when
no mp4 encoder is available.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """gymnasium's default RecordVideo schedule: episodes 0, 1, 8, 27, 64,
    ... (perfect cubes) until 1000, then every 1000th."""
    if episode_id < 1000:
        rounded = int(round(episode_id ** (1.0 / 3)))
        return rounded**3 == episode_id
    return episode_id % 1000 == 0


class VideoRecorder:
    """Accumulates env-0 frames across iterations, splits on dones, and
    writes scheduled episodes as ``rl-video-episode-{k}.gif``."""

    def __init__(
        self,
        video_dir: str,
        episode_trigger=capped_cubic_video_schedule,
        fps: int = 30,
        upscale: int = 2,
    ):
        self.video_dir = video_dir
        self.episode_trigger = episode_trigger
        self.fps = fps
        self.upscale = upscale
        self.episode_id = 0
        self._frames: list[np.ndarray] = []
        os.makedirs(video_dir, exist_ok=True)

    def add_rollout(self, frames: np.ndarray, dones: np.ndarray) -> list[str]:
        """Feed one iteration of env-0 data.

        Args:
            frames: [T, H, W, C] (C=3 RGB, C=4 grayscale stack → last frame)
                or [T, H, W] uint8.
            dones: [T] bool — episode ended *after* step t.

        Returns paths of any videos written.
        """
        frames = np.asarray(frames)
        dones = np.asarray(dones)
        written = []
        for t in range(frames.shape[0]):
            self._frames.append(frames[t])
            if dones[t]:
                path = self._finish_episode()
                if path:
                    written.append(path)
        return written

    def _to_rgb(self, frame: np.ndarray) -> np.ndarray:
        if frame.ndim == 2:
            frame = frame[..., None]
        if frame.shape[-1] == 4:  # grayscale stack → newest frame
            frame = frame[..., -1:]
        if frame.shape[-1] == 1:
            frame = np.repeat(frame, 3, axis=-1)
        if self.upscale > 1:
            frame = frame.repeat(self.upscale, axis=0).repeat(self.upscale, axis=1)
        return frame

    def _finish_episode(self) -> Optional[str]:
        frames, self._frames = self._frames, []
        episode_id, self.episode_id = self.episode_id, self.episode_id + 1
        if not frames or not self.episode_trigger(episode_id):
            return None
        rgb = [self._to_rgb(f) for f in frames]
        path = self._write_mp4(rgb, episode_id)
        if path is None:
            path = self._write_gif(rgb, episode_id)
        return path

    def _write_mp4(self, rgb: list[np.ndarray], episode_id: int) -> Optional[str]:
        """Reference artifact format: ``rl-video-episode-{k}.mp4``
        (`ppo_minigrid.py:115-116` via gymnasium RecordVideo)."""
        try:
            import cv2
        except ImportError:
            return None
        path = os.path.join(self.video_dir, f"rl-video-episode-{episode_id}.mp4")
        h, w = rgb[0].shape[:2]
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
        )
        if not writer.isOpened():
            return None
        for frame in rgb:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB → BGR
        writer.release()
        return path

    def _write_gif(self, rgb: list[np.ndarray], episode_id: int) -> str:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in rgb]
        path = os.path.join(self.video_dir, f"rl-video-episode-{episode_id}.gif")
        imgs[0].save(
            path,
            save_all=True,
            append_images=imgs[1:],
            duration=max(1, int(1000 / self.fps)),
            loop=0,
        )
        return path

    def close(self) -> None:
        self._frames = []
