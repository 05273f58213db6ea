/* XRSLAM C ABI — the flat C surface of xrslam_tpu.
 *
 * Mirrors the reference interface (reference:
 * xrslam-interface/include/XRSLAM.h:195-230 — XRSLAMCreate /
 * XRSLAMPushSensorData / XRSLAMRunOneFrame / XRSLAMGetResult /
 * XRSLAMDestroy over a process-wide engine) so that players, ROS nodes
 * and mobile shells can link against the JAX engine the same way
 * they link against the reference's C++ core. The implementation
 * (xr_capi.cpp) embeds CPython and drives xrslam_tpu.api.XRSLAM.
 *
 * One deliberate deviation: the reference's XRSLAMFeatures accidentally
 * contains a std::vector (not valid C); here it is a plain
 * pointer+count pair like XRSLAMLandmarks.
 */

#ifndef XRSLAM_TPU_CAPI_H_
#define XRSLAM_TPU_CAPI_H_
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum XRSLAMSensorType {
    XRSLAM_SENSOR_CAMERA = 0,
    XRSLAM_SENSOR_DEPTH_CAMERA,
    XRSLAM_SENSOR_ACCELERATION,
    XRSLAM_SENSOR_GYROSCOPE,
    XRSLAM_SENSOR_GRAVITY,
    XRSLAM_SENSOR_ROTATION_VECTOR,
    XRSLAM_SENSOR_UNKNOWN
} XRSLAMSensorType;

typedef struct XRSLAMImageExtension {
    double exposure_time;
    double default_focus_distance;
    double focal_length;
    double focus_distance;
} XRSLAMImageExtension;

/* gray (channel=1) or interleaved RGB/RGBA image; image height comes
 * from the device config's camera resolution */
typedef struct XRSLAMImage {
    unsigned char *data;
    double timeStamp; /* seconds */
    int stride;       /* bytes per row */
    int camera_id;
    int channel;
    XRSLAMImageExtension *ext; /* optional, may be NULL */
} XRSLAMImage;

typedef struct XRSLAMDepthImage {
    uint16_t *data;       /* depth in millimeters, 0 = invalid */
    uint16_t *confidence; /* optional, may be NULL */
    double timeStamp;
} XRSLAMDepthImage;

typedef struct XRSLAMAcceleration {
    double data[3];
    double timestamp;
} XRSLAMAcceleration;

typedef struct XRSLAMGyroscope {
    double data[3];
    double timestamp;
} XRSLAMGyroscope;

typedef struct XRSLAMGravity {
    double data[3];
    double timestamp;
} XRSLAMGravity;

typedef struct XRSLAMRotationVector {
    double data[4];
    double timestamp;
} XRSLAMRotationVector;

typedef enum XRSLAMResultType {
    XRSLAM_RESULT_BODY_POSE = 0,
    XRSLAM_RESULT_CAMERA_POSE,
    XRSLAM_RESULT_STATE,
    XRSLAM_RESULT_LANDMARKS,
    XRSLAM_RESULT_FEATURES,
    XRSLAM_RESULT_BIAS,
    XRSLAM_RESULT_DEBUG_LOGS,
    XRSLAM_RESULT_VERSION,
    XRSLAM_RESULT_UNKNOWN,
    XRSLAM_INFO_INTRINSICS
} XRSLAMResultType;

/* world->camera convention of the reference: X_c = R * X_w + T;
 * quaternion in [x, y, z, w] order */
typedef struct XRSLAMPose {
    double quaternion[4];
    double translation[3];
    double timestamp;
} XRSLAMPose;

typedef struct XRSLAMIntrinsics {
    double fx, fy, cx, cy;
} XRSLAMIntrinsics;

typedef enum XRSLAMState {
    XRSLAM_STATE_INITIALIZING = 0,
    XRSLAM_STATE_TRACKING_SUCCESS,
    XRSLAM_STATE_TRACKING_FAIL
} XRSLAMState;

typedef struct XRSLAMLandmark {
    double x, y, z;
} XRSLAMLandmark;

/* landmark buffer owned by the library; valid until the next
 * XRSLAMGetResult / XRSLAMDestroy call */
typedef struct XRSLAMLandmarks {
    XRSLAMLandmark *landmarks;
    int num_landmarks;
} XRSLAMLandmarks;

typedef struct XRSLAMFeature {
    double x, y;
} XRSLAMFeature;

typedef struct XRSLAMFeatures {
    XRSLAMFeature *features;
    int num_features;
} XRSLAMFeatures;

typedef struct XRSLAMBias {
    double data[3];
} XRSLAMBias;

typedef struct XRSLAMIMUBias {
    XRSLAMBias acc_bias;
    XRSLAMBias gyr_bias;
} XRSLAMIMUBias;

/* string buffer owned by the library; valid until the next
 * XRSLAMGetResult / XRSLAMDestroy call */
typedef struct XRSLAMStringOutput {
    int str_length;
    char *data;
} XRSLAMStringOutput;

/* Create the process-wide SLAM engine from a slam + device YAML pair
 * (configs/euroc_slam.yaml, configs/euroc_sensor.yaml). license_path /
 * product_name are accepted for reference-interface compatibility and
 * ignored. *config receives an opaque engine token (may be NULL).
 * Returns 1 on success, 0 on failure. */
int XRSLAMCreate(const char *slam_config_path,
                 const char *device_config_path, const char *license_path,
                 const char *product_name, void **config);

void XRSLAMPushSensorData(XRSLAMSensorType sensor_type, void *sensor_data);

void XRSLAMRunOneFrame(void);

void XRSLAMSetViewer(void *viewer);

void XRSLAMGetResult(XRSLAMResultType result_type, void *result_data);

void XRSLAMDestroy(void);

/* Non-reference extension: last error message ("" when none). */
const char *XRSLAMGetLastError(void);

#ifdef __cplusplus
}
#endif

#endif /* XRSLAM_TPU_CAPI_H_ */
