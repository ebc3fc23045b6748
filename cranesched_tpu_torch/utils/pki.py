"""Cluster PKI + TLS plumbing: the transport-security layer.

The reference secures its fabric with optional TLS using distinct
internal/external certificate domains (reference:
src/CraneCtld/CtldPublicDefs.h:133-143) and signs per-user mTLS
certificates through HashiCorp Vault (src/CraneCtld/Security/
VaultClient.h:39-43).  Here the CA lives in the cluster itself: a
self-signed cluster CA on the ctld host signs every endpoint
certificate (ctld server, per-craned, cfored hubs), so round-3's
bearer tokens stop traveling plaintext.  Deployments that already run
Vault can drop its CA/cert files into the same config keys — nothing
in this module insists on being the issuer.

Three layers:

* key material  — ``create_ca`` / ``issue_cert`` (X.509 via the
  ``cryptography`` package; RSA-2048, SAN-based hostname binding);
* config        — ``TlsConfig`` (paths + mTLS flag), parsed from the
  ``Tls:`` section of config.yaml by utils/config.py;
* gRPC glue     — ``server_credentials`` / ``secure_channel`` used by
  rpc/server.py, rpc/stub.py, rpc/cfored.py and the craned daemon.

Insecure mode (no TlsConfig) remains fully supported: simulations,
unit tests, and trusted-loopback deployments run exactly as before.

Identity-pinning convention: every issued cert carries its ``name`` as
a DNS SAN, and dialers pin the expected peer NAME via
``override_authority`` — the CLI and craneds pin ``"ctld"`` (issue the
control-plane cert as ``cpki issue ctld``), the ctld dispatcher pins
each craned's node name.  Without pinning, any cluster-issued cert
(e.g. a user's cfored-hub cert, which must be a valid TLS server)
could impersonate the ctld on a shared host, because loopback SANs are
added to every cert for single-host convenience.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os


@dataclasses.dataclass
class TlsConfig:
    """Transport security for one endpoint (server or client).

    ``ca`` is required — it anchors verification in both directions.
    ``cert``/``key`` identify this endpoint: required for servers,
    required for clients only when the peer demands mTLS
    (``require_client_cert`` on the internal surface).
    ``override_authority`` lets a client validate a server cert issued
    for a DNS name while dialing an IP (the reference reaches the same
    effect by dialing hostnames from config)."""

    ca: str
    cert: str = ""
    key: str = ""
    require_client_cert: bool = False
    override_authority: str = ""

    def for_client(self) -> "TlsConfig":
        """A client view of this endpoint config (same files)."""
        return dataclasses.replace(self, require_client_cert=False)

    def pinned(self, authority: str) -> "TlsConfig":
        """Client view pinned to a specific peer identity (the name the
        peer's cert was issued under) — the impersonation guard."""
        return dataclasses.replace(self, require_client_cert=False,
                                   override_authority=authority)


# ---------------------------------------------------------------------------
# key material
# ---------------------------------------------------------------------------

def _new_key():
    from cryptography.hazmat.primitives.asymmetric import rsa
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _write_key(key, path: str) -> None:
    from cryptography.hazmat.primitives import serialization
    pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as fh:
        fh.write(pem)


def _write_cert(cert, path: str) -> None:
    from cryptography.hazmat.primitives import serialization
    with open(path, "wb") as fh:
        fh.write(cert.public_bytes(serialization.Encoding.PEM))


def _name(cn: str):
    from cryptography import x509
    from cryptography.x509.oid import NameOID
    return x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "crane-cluster"),
        x509.NameAttribute(NameOID.COMMON_NAME, cn),
    ])


def create_ca(directory: str, cn: str = "crane-cluster-ca",
              days: int = 3650) -> tuple[str, str]:
    """Create the cluster CA; returns (ca_cert_path, ca_key_path).

    The key file is 0600 — it stays on the ctld/admin host only (the
    Vault-root analog); craneds and clients receive just the cert."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes

    os.makedirs(directory, exist_ok=True)
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(_name(cn))
            .issuer_name(_name(cn))
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.BasicConstraints(ca=True,
                                                 path_length=0),
                           critical=True)
            .add_extension(x509.KeyUsage(
                digital_signature=True, key_cert_sign=True,
                crl_sign=True, content_commitment=False,
                key_encipherment=False, data_encipherment=False,
                key_agreement=False, encipher_only=False,
                decipher_only=False), critical=True)
            .sign(key, hashes.SHA256()))
    ca_path = os.path.join(directory, "ca.pem")
    key_path = os.path.join(directory, "ca.key")
    _write_cert(cert, ca_path)
    _write_key(key, key_path)
    return ca_path, key_path


def issue_cert(directory: str, name: str, ca_cert: str, ca_key: str,
               dns: tuple[str, ...] = (), ips: tuple[str, ...] = (),
               days: int = 365) -> tuple[str, str]:
    """Sign an endpoint certificate (the SignUserCertificate /
    node-cert analog, VaultClient.h:39).  Returns (cert, key) paths
    ``<name>.pem`` / ``<name>.key`` under ``directory``.

    SANs carry the binding: servers get their hostnames/IPs, client
    (mTLS) certs get their identity as a DNS SAN.  ``localhost`` and
    127.0.0.1 are always included so loopback deployments verify."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key)

    os.makedirs(directory, exist_ok=True)
    with open(ca_cert, "rb") as fh:
        ca = x509.load_pem_x509_certificate(fh.read())
    with open(ca_key, "rb") as fh:
        signer = load_pem_private_key(fh.read(), password=None)

    key = _new_key()
    san_dns = list(dict.fromkeys([name, "localhost", *dns]))
    san_ips = list(dict.fromkeys(["127.0.0.1", *ips]))
    san = [x509.DNSName(d) for d in san_dns]
    for ip in san_ips:
        try:
            san.append(x509.IPAddress(ipaddress.ip_address(ip)))
        except ValueError:
            san.append(x509.DNSName(ip))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(_name(name))
            .issuer_name(ca.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName(san),
                           critical=False)
            .add_extension(x509.BasicConstraints(ca=False,
                                                 path_length=None),
                           critical=True)
            .add_extension(x509.ExtendedKeyUsage([
                x509.oid.ExtendedKeyUsageOID.SERVER_AUTH,
                x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]),
                critical=False)
            .sign(signer, hashes.SHA256()))
    # one filename convention for ctld/craned/user certs alike
    safe = name.replace("/", "_")
    cert_path = os.path.join(directory, f"{safe}.pem")
    key_path = os.path.join(directory, f"{safe}.key")
    _write_cert(cert, cert_path)
    _write_key(key, key_path)
    return cert_path, key_path


# ---------------------------------------------------------------------------
# gRPC glue
# ---------------------------------------------------------------------------

def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def cert_identity(cert_path: str) -> str:
    """The identity a cert was issued under: its first DNS SAN (the
    ``name`` argument of issue_cert), falling back to the CN.  Used to
    advertise a pinnable authority alongside a tls:// address so
    dial-backs can reject other cluster-issued certs (every cert
    carries loopback SANs for single-host convenience, so bare CA
    verification accepts ANY cluster cert on 127.0.0.1)."""
    from cryptography import x509
    from cryptography.x509.oid import ExtensionOID, NameOID
    cert = x509.load_pem_x509_certificate(_read(cert_path))
    try:
        san = cert.extensions.get_extension_for_oid(
            ExtensionOID.SUBJECT_ALTERNATIVE_NAME).value
        names = san.get_values_for_type(x509.DNSName)
        if names:
            return names[0]
    except x509.ExtensionNotFound:
        pass
    cn = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
    return cn[0].value if cn else ""


def server_credentials(tls: TlsConfig):
    """ssl_server_credentials for a TlsConfig (cert+key required).
    With ``require_client_cert`` the server also verifies peers against
    the cluster CA — the mTLS internal surface."""
    import grpc
    if not tls.cert or not tls.key:
        raise ValueError("server TLS requires cert and key paths")
    return grpc.ssl_server_credentials(
        [(_read(tls.key), _read(tls.cert))],
        root_certificates=_read(tls.ca) if tls.require_client_cert
        else None,
        require_client_auth=tls.require_client_cert)


def channel_credentials(tls: TlsConfig):
    import grpc
    return grpc.ssl_channel_credentials(
        root_certificates=_read(tls.ca),
        private_key=_read(tls.key) if tls.key else None,
        certificate_chain=_read(tls.cert) if tls.cert else None)


def secure_channel(address: str, tls: TlsConfig, options=()):
    import grpc
    options = list(options)
    if tls.override_authority:
        options.append(("grpc.ssl_target_name_override",
                        tls.override_authority))
    return grpc.secure_channel(address, channel_credentials(tls),
                               options=options or None)
