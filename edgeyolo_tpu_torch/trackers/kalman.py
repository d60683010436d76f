"""Constant-velocity Kalman filters for tracking (edgeyolo_tpu/trackers/kalman.py).

KalmanFilterXYAH (ByteTrack) and KalmanFilterXYWH (BoT-SORT): an 8-dim
state [pos(4), vel(4)], chi-square gating, noise scaled by the box's height
or size. Host numpy in float64, as in JAX: per-track state is tiny, and the
device's work ends at the detections.
"""

from __future__ import annotations

import numpy as np

# chi-square 0.95 quantiles for gating distance (dof 1..9)
CHI2INV95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilterXYAH:
    """State: [cx, cy, aspect, h, vcx, vcy, va, vh]."""

    ndim = 4

    def __init__(self):
        dt = 1.0
        self._motion_mat = np.eye(8)
        for i in range(4):
            self._motion_mat[i, 4 + i] = dt
        self._update_mat = np.eye(4, 8)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def _std_pos(self, h):
        return [2 * self._std_weight_position * h] * 2 + [1e-2, 2 * self._std_weight_position * h]

    def _std_vel(self, h):
        return [10 * self._std_weight_velocity * h] * 2 + [1e-5, 10 * self._std_weight_velocity * h]

    def initiate(self, measurement: np.ndarray):
        mean = np.concatenate([measurement, np.zeros(4)])
        std = self._std_pos(measurement[3]) + self._std_vel(measurement[3])
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        h = mean[3]
        std_pos = [self._std_weight_position * h] * 2 + [1e-2, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * h] * 2 + [1e-5, self._std_weight_velocity * h]
        motion_cov = np.diag(np.square(std_pos + std_vel))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, means: np.ndarray, covariances: np.ndarray):
        """Vectorized predict over N tracks: means (N,8), covs (N,8,8)."""
        if len(means) == 0:
            return means, covariances
        h = means[:, 3]
        std_pos = np.stack([self._std_weight_position * h, self._std_weight_position * h,
                            np.full_like(h, 1e-2), self._std_weight_position * h], 1)
        std_vel = np.stack([self._std_weight_velocity * h, self._std_weight_velocity * h,
                            np.full_like(h, 1e-5), self._std_weight_velocity * h], 1)
        sqr = np.square(np.concatenate([std_pos, std_vel], 1))
        means = means @ self._motion_mat.T
        mc = np.einsum("ij,njk,lk->nil", self._motion_mat, covariances, self._motion_mat)
        for i in range(len(means)):
            mc[i] += np.diag(sqr[i])
        return means, mc

    def project(self, mean, covariance):
        h = mean[3]
        std = [self._std_weight_position * h] * 2 + [1e-1, self._std_weight_position * h]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T + innovation_cov
        return mean_p, cov_p

    def update(self, mean, covariance, measurement):
        proj_mean, proj_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(proj_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - proj_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ proj_cov @ kalman_gain.T
        return new_mean, new_cov

    def gating_distance(self, mean, covariance, measurements, only_position=False):
        proj_mean, proj_cov = self.project(mean, covariance)
        if only_position:
            proj_mean, proj_cov = proj_mean[:2], proj_cov[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - proj_mean
        chol = np.linalg.cholesky(proj_cov)
        z = np.linalg.solve(chol, d.T)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State: [cx, cy, w, h, ...] with both w and h driving the noise scale."""

    def initiate(self, measurement: np.ndarray):
        mean = np.concatenate([measurement, np.zeros(4)])
        w, h = measurement[2], measurement[3]
        std = [2 * self._std_weight_position * w, 2 * self._std_weight_position * h] * 2 + [
            10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h] * 2
        # order: pos(x,y,w,h), vel(x,y,w,h)
        std = [2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
               2 * self._std_weight_position * w, 2 * self._std_weight_position * h,
               10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h,
               10 * self._std_weight_velocity * w, 10 * self._std_weight_velocity * h]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        w, h = mean[2], mean[3]
        std_pos = [self._std_weight_position * w, self._std_weight_position * h,
                   self._std_weight_position * w, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * w, self._std_weight_velocity * h,
                   self._std_weight_velocity * w, self._std_weight_velocity * h]
        motion_cov = np.diag(np.square(std_pos + std_vel))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, means, covariances):
        if len(means) == 0:
            return means, covariances
        w, h = means[:, 2], means[:, 3]
        std = np.stack([
            self._std_weight_position * w, self._std_weight_position * h,
            self._std_weight_position * w, self._std_weight_position * h,
            self._std_weight_velocity * w, self._std_weight_velocity * h,
            self._std_weight_velocity * w, self._std_weight_velocity * h], 1)
        sqr = np.square(std)
        means = means @ self._motion_mat.T
        mc = np.einsum("ij,njk,lk->nil", self._motion_mat, covariances, self._motion_mat)
        for i in range(len(means)):
            mc[i] += np.diag(sqr[i])
        return means, mc

    def project(self, mean, covariance):
        w, h = mean[2], mean[3]
        std = [self._std_weight_position * w, self._std_weight_position * h,
               self._std_weight_position * w, self._std_weight_position * h]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T + innovation_cov
        return mean_p, cov_p
