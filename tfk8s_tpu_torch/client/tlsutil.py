"""Self-signed PKI for the apiserver — dev/test certificate plumbing.

The reference's client stack exists to carry TLS + credentials to a
secured apiserver: ``clientcmd.BuildConfigFromFlags(kubeconfig)`` →
``rest.Config`` → ``rest.RESTClientFor`` (`k8s-operator.md:93-97`,
images/tf5-tf6) — a real (GKE) apiserver is always HTTPS + authn. This
module is the `kubeadm init phase certs` analogue: mint a CA and issue
server/client certs so the hermetic cluster can run the SAME secured
wire the north star requires, and tests can prove the 401/403 boundary.

Everything returns PEM bytes; nothing here touches global state. Uses the
``cryptography`` package (baked into the image).
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

# Dev certs: 10 years, like kubeadm's CA default. Short-lived rotation is
# a deployment concern; the hermetic cluster only needs validity.
_VALID_DAYS = 3650


@dataclass
class CertKeyPair:
    """A PEM certificate + its PEM private key."""

    cert_pem: bytes
    key_pem: bytes

    def write(self, directory: str, name: str) -> Tuple[str, str]:
        """Write ``<name>.crt`` / ``<name>.key`` under ``directory``;
        returns their paths. Key files are chmod 0600 (same discipline as
        kubeconfig credentials)."""
        os.makedirs(directory, exist_ok=True)
        cert_path = os.path.join(directory, f"{name}.crt")
        key_path = os.path.join(directory, f"{name}.key")
        with open(cert_path, "wb") as f:
            f.write(self.cert_pem)
        with open(key_path, "wb") as f:
            f.write(self.key_pem)
        os.chmod(key_path, 0o600)
        return cert_path, key_path


def _key() -> ec.EllipticCurvePrivateKey:
    # P-256: small certs, fast handshakes; what GKE's own CA issues.
    return ec.generate_private_key(ec.SECP256R1())


def _key_pem(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def _name(cn: str, org: Optional[str] = None) -> x509.Name:
    attrs = [x509.NameAttribute(NameOID.COMMON_NAME, cn)]
    if org:
        # client-cert group convention: k8s reads O= as the user's groups
        attrs.append(x509.NameAttribute(NameOID.ORGANIZATION_NAME, org))
    return x509.Name(attrs)


def _validity(builder: x509.CertificateBuilder) -> x509.CertificateBuilder:
    now = datetime.datetime.now(datetime.timezone.utc)
    return builder.not_valid_before(
        now - datetime.timedelta(minutes=5)  # clock-skew slack
    ).not_valid_after(now + datetime.timedelta(days=_VALID_DAYS))


def generate_ca(cn: str = "tfk8s-ca") -> CertKeyPair:
    """Mint a self-signed CA (the cluster root of trust)."""
    key = _key()
    name = _name(cn)
    builder = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
    )
    cert = _validity(builder).sign(key, hashes.SHA256())
    return CertKeyPair(
        cert.public_bytes(serialization.Encoding.PEM), _key_pem(key)
    )


def issue_cert(
    ca: CertKeyPair,
    cn: str,
    sans: Sequence[str] = ("127.0.0.1", "localhost"),
    client: bool = False,
    org: Optional[str] = None,
) -> CertKeyPair:
    """Issue a leaf cert signed by ``ca``.

    ``client=False`` → serverAuth EKU + SubjectAltNames (IPs recognized
    and encoded as IPAddress entries, everything else DNS);
    ``client=True`` → clientAuth EKU, identity = CN (groups = O, the k8s
    client-cert convention).
    """
    ca_key = serialization.load_pem_private_key(ca.key_pem, password=None)
    ca_cert = x509.load_pem_x509_certificate(ca.cert_pem)
    key = _key()
    builder = (
        x509.CertificateBuilder()
        .subject_name(_name(cn, org))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(
            x509.ExtendedKeyUsage(
                [ExtendedKeyUsageOID.CLIENT_AUTH if client
                 else ExtendedKeyUsageOID.SERVER_AUTH]
            ),
            critical=False,
        )
    )
    if not client:
        alt: list = []
        for san in sans:
            try:
                alt.append(x509.IPAddress(ipaddress.ip_address(san)))
            except ValueError:
                alt.append(x509.DNSName(san))
        builder = builder.add_extension(
            x509.SubjectAlternativeName(alt), critical=False
        )
    cert = _validity(builder).sign(ca_key, hashes.SHA256())
    return CertKeyPair(
        cert.public_bytes(serialization.Encoding.PEM), _key_pem(key)
    )


def cert_common_name(der_or_pem_cert: bytes) -> str:
    """CN of a certificate (DER from ``getpeercert(True)`` or PEM)."""
    try:
        cert = x509.load_der_x509_certificate(der_or_pem_cert)
    except ValueError:
        cert = x509.load_pem_x509_certificate(der_or_pem_cert)
    cns = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
    return cns[0].value if cns else ""
