"""Loader-parity gate for the checked-in EuRoC config pair.

Every Config field must come out of configs/euroc_{slam,sensor}.yaml
with the reference's EuRoC values (reference configs/euroc_slam.yaml,
configs/euroc_sensor.yaml, parsed per
xrslam-extra/src/xrslam/extra/yaml_config.cpp:7-80), and every field
the YAML does NOT set must keep the reference's hardcoded default
(reference xrslam/src/xrslam/config.cpp:16-78). This is the parity
check that the README benchmark command parses its configs as written.
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_YAML = os.path.join(REPO, "configs", "euroc_slam.yaml")
SENSOR_YAML = os.path.join(REPO, "configs", "euroc_sensor.yaml")


@pytest.fixture(scope="module")
def cfg():
    from xrslam_tpu.config import load_config

    return load_config(SLAM_YAML, SENSOR_YAML)


def test_config_files_exist():
    assert os.path.exists(SLAM_YAML)
    assert os.path.exists(SENSOR_YAML)


def test_camera_block(cfg):
    K = cfg.camera_intrinsic
    assert np.allclose(np.diag(K), [458.654, 457.296, 1.0])
    assert np.allclose(K[:2, 2], [367.215, 248.375])
    assert K[0, 1] == 0.0 and K[1, 0] == 0.0
    assert cfg.camera_resolution == (752, 480)
    assert cfg.camera_distortion_flag is True
    assert np.allclose(
        cfg.camera_distortion,
        [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    assert cfg.camera_time_offset == 0.0
    # q_bc is [x,y,z,w] on the wire, [w,x,y,z] in Config
    assert np.allclose(
        cfg.camera_to_body_rotation,
        [7.1230146066895372e-01, -7.7071797555374275e-03,
         1.0499323370587278e-02, 7.0175280029197162e-01])
    assert np.allclose(
        cfg.camera_to_body_translation,
        [-0.0216401454975, -0.064676986768, 0.00981073058949])
    assert np.allclose(cfg.keypoint_noise_cov, 0.5 * np.eye(2))


def test_imu_block(cfg):
    assert np.allclose(cfg.imu_to_body_rotation, [1.0, 0, 0, 0])
    assert np.allclose(cfg.imu_to_body_translation, np.zeros(3))
    assert np.allclose(cfg.gyroscope_noise_cov,
                       2.8791302399999997e-08 * np.eye(3))
    assert np.allclose(cfg.accelerometer_noise_cov, 4.0e-6 * np.eye(3))
    assert np.allclose(cfg.gyroscope_bias_noise_cov,
                       3.7608844899999997e-10 * np.eye(3))
    assert np.allclose(cfg.accelerometer_bias_noise_cov, 9.0e-6 * np.eye(3))
    assert np.allclose(cfg.accelerometer_bias, np.zeros(3))
    assert np.allclose(cfg.gyroscope_bias, np.zeros(3))


def test_output_block(cfg):
    assert np.allclose(cfg.output_to_body_rotation, [1.0, 0, 0, 0])
    assert np.allclose(cfg.output_to_body_translation, np.zeros(3))


def test_slam_params(cfg):
    assert cfg.sliding_window_size == 10
    assert cfg.sliding_window_subframe_size == 3
    assert cfg.sliding_window_force_keyframe_landmarks == 35
    assert cfg.feature_tracker_min_keypoint_distance == 20.0
    assert cfg.feature_tracker_max_keypoint_detection == 200
    assert cfg.feature_tracker_max_init_frames == 60
    assert cfg.feature_tracker_max_frames == 20
    assert cfg.feature_tracker_predict_keypoints is True
    assert cfg.feature_tracker_clahe_clip_limit == 6.0
    assert cfg.feature_tracker_clahe_width == 8
    assert cfg.feature_tracker_clahe_height == 8
    assert cfg.initializer_keyframe_num == 8
    assert cfg.initializer_keyframe_gap == 5
    assert cfg.initializer_min_matches == 50
    assert cfg.initializer_min_parallax == 10.0
    assert cfg.initializer_min_triangulation == 20
    assert cfg.initializer_min_landmarks == 30
    assert cfg.initializer_refine_imu is True
    assert cfg.solver_iteration_limit == 30
    assert cfg.solver_time_limit == 1.0e6
    assert cfg.rotation_misalignment_threshold == 0.02
    assert cfg.rotation_ransac_threshold == 10
    assert cfg.parsac_flag is False
    assert cfg.parsac_dynamic_probability == 0.15
    assert cfg.parsac_threshold == 1.0
    assert cfg.parsac_norm_scale == 1.0
    assert cfg.parsac_keyframe_check_size == 1


def test_defaults_for_unset_fields(cfg):
    """Fields the EuRoC YAML pair leaves unset must keep the
    reference's hardcoded defaults (config.cpp:16-78)."""
    assert cfg.sliding_window_tracker_frequent == 1
    assert cfg.visual_localization_enable is False
    assert cfg.visual_localization_config_ip == "0.0.0.0"
    assert cfg.visual_localization_config_port == 0
    assert cfg.random == 648


def test_dataclass_defaults_match_reference():
    """The bare Config() defaults themselves mirror config.cpp:16-78."""
    from xrslam_tpu.config import Config

    c = Config()
    assert c.sliding_window_size == 10
    assert c.sliding_window_subframe_size == 3
    assert c.sliding_window_force_keyframe_landmarks == 35
    assert c.sliding_window_tracker_frequent == 1
    assert c.feature_tracker_min_keypoint_distance == 20.0
    assert c.feature_tracker_max_keypoint_detection == 150
    assert c.feature_tracker_max_init_frames == 60
    assert c.feature_tracker_max_frames == 200
    assert c.feature_tracker_clahe_clip_limit == 6.0
    assert c.feature_tracker_clahe_width == 8
    assert c.feature_tracker_clahe_height == 8
    assert c.feature_tracker_predict_keypoints is True
    assert c.initializer_keyframe_num == 8
    assert c.initializer_keyframe_gap == 5
    assert c.initializer_min_matches == 50
    assert c.initializer_min_parallax == 10.0
    assert c.initializer_min_triangulation == 50
    assert c.initializer_min_landmarks == 30
    assert c.initializer_refine_imu is True
    assert c.solver_iteration_limit == 10
    assert c.solver_time_limit == 1.0e6
    assert c.rotation_misalignment_threshold == 0.1
    assert c.rotation_ransac_threshold == 10
    assert c.random == 648
    assert c.parsac_flag is False
    assert c.parsac_dynamic_probability == 0.0
    assert c.parsac_threshold == 3.0
    assert c.parsac_norm_scale == 1.0
    assert c.parsac_keyframe_check_size == 3


def test_iphone_mobile_config_pair_loads():
    """The checked-in mobile/iOS config axis
    (configs/iphone_slam.yaml + configs/iphone12_sensor.yaml) loads
    with the reference's values (reference:
    xrslam-ios/visualizer/configs/slam_params.yaml and
    "iPhone 12.yaml") and enables the camera-rate visual-PnP path."""
    import os

    import numpy as np

    from xrslam_tpu.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "iphone_slam.yaml"),
                      os.path.join(repo, "configs", "iphone12_sensor.yaml"))

    # mobile profile (slam_params.yaml)
    assert cfg.sliding_window_size == 5
    assert cfg.sliding_window_tracker_frequent == 3
    assert cfg.solver_time_limit == 0.1
    assert cfg.solver_iteration_limit == 10
    assert cfg.feature_tracker_min_keypoint_distance == 25.0
    assert cfg.feature_tracker_max_keypoint_detection == 300
    assert cfg.visual_pnp_enable is True
    assert cfg.visual_pnp_min_landmarks == 10
    assert cfg.visual_localization_enable is False
    assert cfg.parsac_dynamic_probability == 0.15
    np.testing.assert_allclose(
        cfg.output_to_body_rotation,
        [0.0, -0.7071068, 0.7071068, 0.0])  # wxyz of xyzw input

    # device ("iPhone 12.yaml")
    assert cfg.camera_resolution == (640, 480)
    K = cfg.camera_intrinsic
    np.testing.assert_allclose(
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
        [477.89396911927014, 478.93641880878255,
         320.806586299477, 231.07172384113187])
    assert cfg.camera_distortion_flag is False
    np.testing.assert_allclose(cfg.gyroscope_noise_cov,
                               np.eye(3) * 2.8791302399999997e-8)
    np.testing.assert_allclose(cfg.accelerometer_bias_noise_cov,
                               np.eye(3) * 9.0e-6)
    np.testing.assert_allclose(cfg.camera_to_body_translation,
                               [0.033366085092802436, 0.009419070514053628,
                                -0.006188374507046947])
    np.testing.assert_allclose(cfg.keypoint_noise_cov, np.eye(2) * 0.5)


# --------------------------------------------------------------------------
# the stdlib OpenCV-YAML loader against PyYAML
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rendered_pair(tmp_path_factory):
    from xrslam_tpu.tools.make_dataset import render_dataset

    d = str(tmp_path_factory.mktemp("yaml_pair"))
    paths = render_dataset(d, n_frames=2, n_landmarks=20, width=64,
                           height=48, focal=60.0)
    return {"rendered-slam": paths["slam_yaml"],
            "rendered-device": paths["device_yaml"]}


def _pyyaml_normalized(text):
    """PyYAML's reading, with yaml-cpp's scalar rule applied: PyYAML
    (YAML 1.1) leaves unsigned exponents such as "1.0e6" as strings,
    the reference's yaml-cpp reads them as floats."""
    import re

    yaml = pytest.importorskip("yaml")
    num = re.compile(r"[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")

    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        if isinstance(x, str) and num.match(x):
            return float(x)
        return x

    return norm(yaml.safe_load(text.split("\n", 1)[1]))


@pytest.mark.parametrize("name", [
    "euroc_slam.yaml", "euroc_sensor.yaml", "iphone_slam.yaml",
    "iphone12_sensor.yaml", "rendered-slam", "rendered-device"])
def test_opencv_yaml_loader_matches_pyyaml(name, rendered_pair):
    from xrslam_tpu.config import parse_opencv_yaml

    path = rendered_pair.get(name) or os.path.join(REPO, "configs", name)
    with open(path) as f:
        text = f.read()
    ours = parse_opencv_yaml(text, path)
    assert ours == _pyyaml_normalized(text)
    assert ours, path


def test_opencv_yaml_subset_and_rejects():
    from xrslam_tpu.config import parse_opencv_yaml

    text = ("%YAML:1.0\n"
            "# header comment\n"
            "a:\n"
            "  b: [1, 2.5,\n"
            "      -3e-2]   # trailing comment\n"
            "  c: \"x # not a comment\"\n"
            "  d:\n"
            "e: true\n"
            "f: 1.0e6\n")
    assert parse_opencv_yaml(text) == {
        "a": {"b": [1, 2.5, -0.03], "c": "x # not a comment", "d": None},
        "e": True, "f": 1.0e6}
    for bad in ("a:\n  - 1\n", "a: [1, 2\n", "a: [[1], 2]\n", "just text\n",
                "a: 1\n  b: 2\n", "a:\n    b: 1\n  c: 2\n"):
        with pytest.raises(ValueError):
            parse_opencv_yaml(bad)
